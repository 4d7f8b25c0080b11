"""Optimizers of the port."""

from repro_torch.optim.adamw import OptState, adamw_init, adamw_update

__all__ = ["OptState", "adamw_init", "adamw_update"]
