"""Routes of the fused ResNet kernels K3 (``fused_matmul``), K4
(``fused_conv``) and K5 (``fused_chain``): which CUDA kernel a call on the
card takes, that every
ResNet-50 B256/224 call takes the tensor-core route, that the wrappers'
partial and split sizes cover every row once, and that calls on the CPU
launch nothing. The kernels themselves run only on the card
(``chip_smoke.py``)."""
import re

import pytest
import torch

import chip_smoke
from bigdl_tpu_torch import kernels
from bigdl_tpu_torch.kernels import _build
from bigdl_tpu_torch.kernels import fused_chain as fch
from bigdl_tpu_torch.kernels import fused_conv as fc
from bigdl_tpu_torch.kernels import fused_matmul as fm

torch.set_num_threads(1)
ROUTES = {"bf16_sm90", "bf16_ragged", "f32"}

# ResNet-50 at B256/224: the shape tables chip_smoke.py checks and times
# on the card (models/resnet.py: conv1 of block 0, conv3 and projection per
# stage for K3; the 3x3 convs for K4; the junctions for K5)
B = chip_smoke.RB
K3_SHAPES = [shape[:3] for _, shape, _ in chip_smoke.RESNET_K3]
K4_SHAPES = [shape for _, shape, _ in chip_smoke.RESNET_K4]
K5_SHAPES = [shape for _, shape, _ in chip_smoke.RESNET_K5]


def test_resnet50_tables_hold_every_fused_launch_of_a_step():
    """24 K3, 16 K4 (with fused_conv2) and 12 K5 launches a step, the
    counts chip_smoke.py's training phases check."""
    assert B == 256
    assert sum(n for _, _, n in chip_smoke.RESNET_K3) == 24
    assert sum(n for _, _, n in chip_smoke.RESNET_K4) == 16
    assert sum(n for _, _, n in chip_smoke.RESNET_K5) == 12
    assert set(chip_smoke.JSON_SHAPES) <= {
        name for table in (chip_smoke.RESNET_K3, chip_smoke.RESNET_K4,
                           chip_smoke.RESNET_K5) for name, _, _ in table}


def test_fused_routes_by_dtype_and_one_shape_rule():
    """bf16 with contraction and columns multiples of 8 goes to the
    tensor-core sources, other bf16 shapes and float32 to the CUDA-core
    ones; every route's library is in the build list with its headers."""
    assert fm._ROUTES == {torch.bfloat16: "bf16_sm90", torch.float32: "f32"}
    assert fm.route(torch.bfloat16, 64, 256) == "bf16_sm90"
    assert fm.route(torch.bfloat16, 24, 40) == "bf16_sm90"
    assert fm.route(torch.bfloat16, 130, 64) == "bf16_ragged"
    assert fm.route(torch.bfloat16, 64, 70) == "bf16_ragged"
    assert fm.route(torch.float32, 64, 256) == "f32"
    for table in (fm._FWD_FN, fm._BWD_FN, fc._FWD_FN, fch._FWD_FN,
                  fch._BWD_FN):
        assert set(table) == ROUTES
        assert table["bf16_sm90"][0].endswith("_sm90")
        assert table["bf16_ragged"] == table["f32"]
        for lib, _ in table.values():
            for f in _build.SOURCES[lib]:
                assert (_build.CSRC / f).exists(), f
    assert fch._FWD_FN["bf16_sm90"] == ("fused_chain_sm90",
                                        "bigdl_fused_chain_sm90_fwd")
    assert fch._BWD_FN["f32"] == ("fused_chain", "bigdl_fused_chain_bwd")
    assert fch.route is fm.route      # K5 takes K3's rule over (K, N)
    for name in ("fused_matmul_fwd", "fused_matmul_bwd", "fused_conv_fwd",
                 "fused_chain_fwd", "fused_chain_bwd"):
        assert set(kernels.WRAPPERS[name].launches_by_route) == ROUTES


@pytest.mark.parametrize("lib", ["fused_matmul_sm90", "fused_conv_sm90",
                                 "fused_chain_sm90"])
def test_tensor_core_sources_call_no_library(lib):
    """The products are PTX wgmma written out in the core header; no
    source or header of the library names a GEMM or conv library."""
    for f in _build.SOURCES[lib]:
        text = (_build.CSRC / f).read_text().lower()
        for word in ("cublas", "cudnn", "cutlass/gemm", "cutlass/conv"):
            assert word not in text, (f, word)
    core = (_build.CSRC / "fused_gemm_sm90.cuh").read_text()
    assert "fused_gemm_sm90.cuh" in _build.SOURCES[lib]
    assert re.search(r"wgmma\.mma_async\.sync\.aligned\.m64n\d+k16", core)


@pytest.mark.parametrize("M,K,N", K3_SHAPES)
def test_resnet50_k3_calls_take_the_tensor_core_route(M, K, N):
    assert fm.route(torch.bfloat16, K, N) == "bf16_sm90"
    assert K % 64 == 0 and N % 64 == 0
    # one partial of the column sums per 64 rows: every row in exactly one
    rows = fm._PART_ROWS["bf16_sm90"]
    parts = -(-M // rows)
    assert (parts - 1) * rows < M <= parts * rows
    splits, per = fm.dw_splits_sm90(M, K, N)
    assert per % 128 == 0 and (splits - 1) * per < M <= splits * per


@pytest.mark.parametrize("H,C,N,stride", K4_SHAPES)
def test_resnet50_k4_calls_take_the_tensor_core_route(H, C, N, stride):
    assert fm.route(torch.bfloat16, C, N) == "bf16_sm90"
    assert C % 64 == 0   # a 64-deep chunk of the contraction is one tap
    H2 = -(-H // stride)
    M = B * H2 * H2
    rows = fm._PART_ROWS["bf16_sm90"]
    parts = -(-M // rows)
    assert (parts - 1) * rows < M <= parts * rows


@pytest.mark.parametrize("H,K,N", K5_SHAPES)
def test_resnet50_k5_calls_take_the_tensor_core_route(H, K, N):
    """Every junction (K = 4 N, N = 64 ... 512) takes bf16_sm90: its
    forward's column tiles (64 wide at N = 64, else 128) leave h to the
    first; partials and dw splits cover every row once."""
    assert fm.route(torch.bfloat16, K, N) == "bf16_sm90"
    assert K == 4 * N and N % 64 == 0
    M = B * H * H
    rows = fm._PART_ROWS["bf16_sm90"]
    parts = -(-M // rows)
    assert (parts - 1) * rows < M <= parts * rows
    splits, per = fm.dw_splits_sm90(M, K, N)
    assert per % 128 == 0 and (splits - 1) * per < M <= splits * per


@pytest.mark.parametrize("M,K,N", [(802816, 64, 256), (802816, 64, 64),
                                   (12544, 1024, 2048), (50176, 512, 1024),
                                   (300, 24, 40), (1, 8, 8), (129, 16, 8)])
def test_dw_splits_sm90_cover_every_row_once(M, K, N):
    """Splits of 128-row multiples (the two warpgroups take alternate
    64-pixel chunks) that together hold every pixel once, and about one
    block per SM at the large shapes."""
    splits, per = fm.dw_splits_sm90(M, K, N)
    assert per % 128 == 0 and splits >= 1 and per >= 128
    assert (splits - 1) * per < M <= splits * per
    bn = 64 if N <= 64 else 128
    blocks = splits * -(-K // 64) * -(-N // bn)
    if M >= 12544:
        assert fm._SMS // 2 <= blocks <= 2 * fm._SMS


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
def test_cpu_fused_calls_launch_nothing_on_any_route(dt):
    kernels.reset_launch_counts()
    for K, N in ((16, 24), (130, 70)):      # the sm90 rule and a ragged shape
        x = torch.randn(40, K).to(dt)
        w = torch.randn(K, N).to(dt)
        a, b = torch.rand(K) + 0.5, torch.randn(K)
        z, s1, s2 = kernels.fused_matmul_fwd(x, w, a, b, True, True)
        kernels.fused_matmul_bwd(x, w, a, b, z, torch.randn(40, N).to(dt),
                                 torch.randn(N), torch.randn(N), True, True)
        kernels.fused_conv_fwd(torch.randn(1, 5, 5, K).to(dt),
                               torch.randn(3, 3, K, N).to(dt), a, b, 2, True)
        z5, r5 = torch.randn(40, K).to(dt), torch.randn(40, K).to(dt)
        h, zo, s1, s2 = kernels.fused_chain_fwd(z5, r5, a, b, w, True)
        kernels.fused_chain_bwd(z5, r5, a, b, w, zo, torch.randn(40, K),
                                torch.randn(40, N), s1, s2, True)
    for counts in kernels.launches_by_route().values():
        assert set(counts.values()) == {0}
    assert set(kernels.launch_counts().values()) == {0}


def test_parameter_copies_are_16_byte_aligned():
    """The per-channel vectors reach the tensor-core kernels through
    16-byte copies: an offset view comes back as an aligned copy."""
    from bigdl_tpu_torch.kernels.fused_matmul import _f32
    base = torch.arange(20, dtype=torch.float32)
    view = base[1:17]
    assert view.data_ptr() % 16 != 0
    got = _f32(view)
    assert got.data_ptr() % 16 == 0 and torch.equal(got, view)
    assert _f32(base) is base and _f32(None) is None
    assert _f32(base.to(torch.bfloat16)).dtype == torch.float32
