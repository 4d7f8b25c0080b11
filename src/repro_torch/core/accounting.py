"""Layer and network specs of the paper's six generators.

A copy of the JAX package's ``core/accounting.py`` specs (the port keeps
its own copy and imports nothing of ``repro``): ``LayerSpec`` /
``NetworkSpec`` with their MAC and parameter accounting, the six paper
networks of Section 5.1 (:data:`BENCHMARKS`, 22 deconv layers), and the
N-D workloads beyond the paper (:data:`WORKLOADS` adds the 1-D
``wavegan``, the 3-D ``voxgan`` and the 2-D ``segnet``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import List, Optional, Sequence, Tuple


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


@dataclass(frozen=True)
class LayerSpec:
    """One layer of a benchmark network, with resolved input geometry.

    ``in_hw`` is the input *spatial* shape; its length sets the layer's
    spatial rank (1 = audio, 2 = images — the historical default — and
    3 = volumetric).  Kernels and strides stay scalar (hypercubic), as
    in every benchmarked network.
    """
    kind: str                      # 'conv' | 'deconv' | 'fc'
    cin: int
    cout: int
    k: int = 0                     # spatial kernel (hypercubic)
    s: int = 1                     # stride
    in_hw: Tuple[int, ...] = (1, 1)
    padding: str = "same"          # 'same' (TF semantics) or int in .pad
    pad: int = 0
    name: str = ""

    # ---- geometry -------------------------------------------------------
    @property
    def rank(self) -> int:
        """Spatial rank of the layer (len of its input spatial shape)."""
        return len(self.in_hw)

    def out_hw(self) -> Tuple[int, ...]:
        if self.kind == "fc":
            return (1,) * self.rank
        if self.kind == "conv":
            if self.padding == "same":
                return tuple(-(-n // self.s) for n in self.in_hw)
            return tuple((n + 2 * self.pad - self.k) // self.s + 1
                         for n in self.in_hw)
        # deconv
        if self.padding == "same":
            return tuple(n * self.s for n in self.in_hw)
        return tuple((n - 1) * self.s + self.k - 2 * self.pad
                     for n in self.in_hw)

    # ---- accounting -----------------------------------------------------
    def macs(self) -> int:
        """Original (useful) multiply-accumulate count."""
        if self.kind == "fc":
            return self.cin * self.cout
        taps = self.k ** self.rank * self.cin * self.cout
        if self.kind == "conv":
            return math.prod(self.out_hw()) * taps
        return math.prod(self.in_hw) * taps

    def nzp_macs(self) -> int:
        if self.kind != "deconv":
            return self.macs()
        return (math.prod(self.out_hw())
                * self.k ** self.rank * self.cin * self.cout)

    def sd_expansion(self) -> float:
        """MAC/param expansion ratio of general SD: (s*ceil(K/s)/K)^d."""
        if self.kind != "deconv" or self.s == 1:
            return 1.0
        kt = -(-self.k // self.s)
        return (self.s * kt / self.k) ** self.rank

    def sd_macs(self) -> int:
        return int(round(self.macs() * self.sd_expansion()))

    def params(self) -> int:
        if self.kind == "fc":
            return self.cin * self.cout
        return self.k ** self.rank * self.cin * self.cout

    def sd_params(self) -> int:
        return int(round(self.params() * self.sd_expansion()))

    def sd_params_compressed(self) -> int:
        return self.params()


@dataclass
class NetworkSpec:
    name: str
    layers: List[LayerSpec]
    note: str = ""
    # Head semantics: generators squash to [-1, 1]; dense-prediction
    # heads (segmentation logits) must NOT.  Carried on the spec so the
    # model factory and the serving stack can never disagree.
    final_tanh: bool = True

    def deconv_layers(self) -> List[LayerSpec]:
        return [l for l in self.layers if l.kind == "deconv"]

    def total_macs(self) -> int:
        return sum(l.macs() for l in self.layers)

    def deconv_macs(self) -> int:
        return sum(l.macs() for l in self.deconv_layers())

    def deconv_nzp_macs(self) -> int:
        return sum(l.nzp_macs() for l in self.deconv_layers())

    def deconv_sd_macs(self) -> int:
        return sum(l.sd_macs() for l in self.deconv_layers())

    def deconv_params(self) -> int:
        return sum(l.params() for l in self.deconv_layers())

    def deconv_sd_params(self) -> int:
        return sum(l.sd_params() for l in self.deconv_layers())

    def deconv_sd_params_compressed(self) -> int:
        return sum(l.sd_params_compressed() for l in self.deconv_layers())


# ---------------------------------------------------------------------------
# Benchmark networks (paper Section 5.1) — layer dims reconstructed to exact
# agreement with Tables 1-3 where derivable (see EXPERIMENTS.md for the
# residuals on the handful of entries the paper under-specifies).
# ---------------------------------------------------------------------------

def dcgan() -> NetworkSpec:
    """DCGAN generator, CelebA 64x64, 5x5 stride-2 SAME deconvs.

    Exact match: Table 1 total 111.41M, Table 2 (109.77 / 439.09 / 158.07)M,
    Table 3 (1.03 / 1.48 / 1.04)M.
    """
    return NetworkSpec("DCGAN", [
        LayerSpec("fc", 100, 8 * 8 * 256, name="project"),
        LayerSpec("deconv", 256, 128, k=5, s=2, in_hw=(8, 8), name="d1"),
        LayerSpec("deconv", 128, 64, k=5, s=2, in_hw=(16, 16), name="d2"),
        LayerSpec("deconv", 64, 3, k=5, s=2, in_hw=(32, 32), name="d3"),
    ])


def sngan() -> NetworkSpec:
    """SNGAN (DCGAN-style) generator, CIFAR-10 32x32, 4x4 stride-2 deconvs.

    Deconv column exact: 100.66M / 402.65M / 100.66M.
    """
    return NetworkSpec("SNGAN", [
        LayerSpec("fc", 128, 4 * 4 * 512, name="project"),
        LayerSpec("deconv", 512, 256, k=4, s=2, in_hw=(4, 4), name="d1"),
        LayerSpec("deconv", 256, 128, k=4, s=2, in_hw=(8, 8), name="d2"),
        LayerSpec("deconv", 128, 64, k=4, s=2, in_hw=(16, 16), name="d3"),
        LayerSpec("conv", 64, 3, k=3, s=1, in_hw=(32, 32), name="to_rgb"),
    ])


def artgan() -> NetworkSpec:
    """ArtGAN generator (64x64 variant).

    Deconv column exact: 822.08M / 2030.04M / 822.08M (the 5x5 stride-1
    deconv is why ArtGAN's NZP blow-up is 2.47x rather than 4x).
    """
    return NetworkSpec("ArtGAN", [
        LayerSpec("fc", 110, 4 * 4 * 1024, name="project"),
        LayerSpec("deconv", 1024, 512, k=4, s=2, in_hw=(4, 4), name="d1"),
        LayerSpec("conv", 512, 512, k=3, s=1, in_hw=(8, 8), name="c1"),
        LayerSpec("deconv", 512, 256, k=4, s=2, in_hw=(8, 8), name="d2"),
        LayerSpec("deconv", 256, 128, k=4, s=2, in_hw=(16, 16), name="d3"),
        LayerSpec("deconv", 128, 128, k=5, s=1, in_hw=(32, 32), name="d4_s1"),
        LayerSpec("conv", 128, 128, k=3, s=1, in_hw=(32, 32), name="c2"),
        LayerSpec("conv", 128, 128, k=3, s=1, in_hw=(32, 32), name="c3"),
        LayerSpec("conv", 128, 3, k=3, s=1, in_hw=(32, 32), name="to_rgb"),
    ])


def gpgan() -> NetworkSpec:
    """GP-GAN blending autoencoder, 64x64.

    Exact: total 241.2M (paper 240.39M, +0.3%), deconv 103.81M exact.
    """
    return NetworkSpec("GP-GAN", [
        LayerSpec("conv", 3, 64, k=4, s=2, in_hw=(64, 64), name="e1"),
        LayerSpec("conv", 64, 128, k=4, s=2, in_hw=(32, 32), name="e2"),
        LayerSpec("conv", 128, 256, k=4, s=2, in_hw=(16, 16), name="e3"),
        LayerSpec("conv", 256, 512, k=4, s=2, in_hw=(8, 8), name="e4"),
        LayerSpec("fc", 4 * 4 * 512, 2048, name="bottleneck_in"),
        LayerSpec("fc", 2048, 4 * 4 * 512, name="bottleneck_out"),
        LayerSpec("deconv", 512, 256, k=4, s=2, in_hw=(4, 4), name="d1"),
        LayerSpec("deconv", 256, 128, k=4, s=2, in_hw=(8, 8), name="d2"),
        LayerSpec("deconv", 128, 64, k=4, s=2, in_hw=(16, 16), name="d3"),
        LayerSpec("deconv", 64, 3, k=4, s=2, in_hw=(32, 32), name="d4"),
    ])


def mde() -> NetworkSpec:
    """Monocular depth estimation (Godard et al.) decoder, 512x256 input.

    Deconv params exact vs Table 3 (3.93M / 6.99M); deconv MACs 830.4M
    (paper 849.35M, -2.2%: the paper's exact feature resolutions are not
    recoverable).  3x3 stride-2 upconvs -> 16/9 SD expansion, as in paper.
    """
    enc = [  # VGG-ish encoder (paper total 2638.22M; ours approximates)
        LayerSpec("conv", 3, 32, k=7, s=2, in_hw=(256, 512), name="e1"),
        LayerSpec("conv", 32, 64, k=5, s=2, in_hw=(128, 256), name="e2"),
        LayerSpec("conv", 64, 128, k=3, s=2, in_hw=(64, 128), name="e3"),
        LayerSpec("conv", 128, 256, k=3, s=2, in_hw=(32, 64), name="e4"),
        LayerSpec("conv", 256, 512, k=3, s=2, in_hw=(16, 32), name="e5"),
        LayerSpec("conv", 512, 512, k=3, s=2, in_hw=(8, 16), name="e6"),
    ]
    dec = [
        LayerSpec("deconv", 512, 512, k=3, s=2, in_hw=(4, 8), name="up6"),
        LayerSpec("deconv", 512, 256, k=3, s=2, in_hw=(8, 16), name="up5"),
        LayerSpec("deconv", 256, 128, k=3, s=2, in_hw=(16, 32), name="up4"),
        LayerSpec("deconv", 128, 64, k=3, s=2, in_hw=(32, 64), name="up3"),
        LayerSpec("deconv", 64, 32, k=3, s=2, in_hw=(64, 128), name="up2"),
        LayerSpec("deconv", 32, 16, k=3, s=2, in_hw=(128, 256), name="up1"),
        LayerSpec("conv", 16, 1, k=3, s=1, in_hw=(256, 512), name="disp"),
    ]
    return NetworkSpec("MDE", enc + dec)


def fst() -> NetworkSpec:
    """Fast-Style-Transfer (Johnson), 256x256 input.

    Deconv column exact: 603.98M / 2415.92M / 1073.74M; deconv params
    exact 0.09M / 0.15M / 0.09M.  (The paper's 94.7B total operand count
    is not reproducible from the published architecture — ours is the
    standard 8.3B; flagged in EXPERIMENTS.md.)
    """
    res = []
    for i in range(5):  # 5 residual blocks at 64x64, 128 ch
        res += [LayerSpec("conv", 128, 128, k=3, s=1, in_hw=(64, 64),
                          name=f"res{i}a"),
                LayerSpec("conv", 128, 128, k=3, s=1, in_hw=(64, 64),
                          name=f"res{i}b")]
    return NetworkSpec("FST", [
        LayerSpec("conv", 3, 32, k=9, s=1, in_hw=(256, 256), name="c1"),
        LayerSpec("conv", 32, 64, k=3, s=2, in_hw=(256, 256), name="c2"),
        LayerSpec("conv", 64, 128, k=3, s=2, in_hw=(128, 128), name="c3"),
        *res,
        LayerSpec("deconv", 128, 64, k=3, s=2, in_hw=(64, 64), name="d1"),
        LayerSpec("deconv", 64, 32, k=3, s=2, in_hw=(128, 128), name="d2"),
        LayerSpec("conv", 32, 3, k=9, s=1, in_hw=(256, 256), name="to_rgb"),
    ])


BENCHMARKS = {"dcgan": dcgan, "artgan": artgan, "sngan": sngan,
              "gpgan": gpgan, "mde": mde, "fst": fst}


# ---------------------------------------------------------------------------
# N-D workloads beyond the paper: the same split-deconv substrate applied
# to audio (1-D), volumetric generation (3-D) and dense segmentation
# decoding.  They are not among the paper's six benchmarks (BENCHMARKS
# stays exactly the paper's set); models and servers look nets up in
# WORKLOADS.
# ---------------------------------------------------------------------------

def wavegan() -> NetworkSpec:
    """WaveGAN-style 1-D audio generator (Donahue et al.), scaled to a
    1024-sample clip: 25-tap stride-4 transposed convs (K % s == 1, so
    the SD expansion is (4*7/25)^1 = 1.12x)."""
    return NetworkSpec("WaveGAN", [
        LayerSpec("fc", 100, 16 * 64, name="project"),
        LayerSpec("deconv", 64, 32, k=25, s=4, in_hw=(16,), name="up1"),
        LayerSpec("deconv", 32, 16, k=25, s=4, in_hw=(64,), name="up2"),
        LayerSpec("deconv", 16, 1, k=25, s=4, in_hw=(256,),
                  name="to_audio"),
    ], note="1-D audio synthesis; final tanh = waveform in [-1, 1]")


def voxgan() -> NetworkSpec:
    """3D-GAN-style voxel generator (Wu et al.), 4^3 -> 32^3 occupancy
    grid via 4x4x4 stride-2 transposed convs (K % s == 0: SD is
    expansion-free in every dim)."""
    return NetworkSpec("VoxGAN", [
        LayerSpec("fc", 64, 4 ** 3 * 64, name="project"),
        LayerSpec("deconv", 64, 32, k=4, s=2, in_hw=(4, 4, 4), name="up1"),
        LayerSpec("deconv", 32, 16, k=4, s=2, in_hw=(8, 8, 8), name="up2"),
        LayerSpec("deconv", 16, 1, k=4, s=2, in_hw=(16, 16, 16),
                  name="to_vox"),
    ], note="3-D volumetric generation; final tanh = occupancy in [-1, 1]")


def segnet() -> NetworkSpec:
    """SegNet-style encoder-decoder segmentation head: strided conv
    encoder, deconv decoder back to input resolution, dense per-pixel
    class logits (``final_tanh=False``)."""
    return NetworkSpec("SegNet", [
        LayerSpec("conv", 3, 32, k=3, s=2, in_hw=(32, 32), name="e1"),
        LayerSpec("conv", 32, 64, k=3, s=2, in_hw=(16, 16), name="e2"),
        LayerSpec("deconv", 64, 32, k=4, s=2, in_hw=(8, 8), name="d1"),
        LayerSpec("deconv", 32, 16, k=4, s=2, in_hw=(16, 16), name="d2"),
        LayerSpec("conv", 16, 21, k=3, s=1, in_hw=(32, 32), name="logits"),
    ], note="2-D dense prediction; 21-class (VOC-sized) logit head",
        final_tanh=False)


WORKLOADS = {**BENCHMARKS, "wavegan": wavegan, "voxgan": voxgan,
             "segnet": segnet}
