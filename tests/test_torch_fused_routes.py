"""Routes of the fused ResNet kernels K3 (``fused_matmul``), K4
(``fused_conv``) and K5 (``fused_chain``): which CUDA kernel a call on the
card takes, that every ResNet-50 call takes a tensor-core route (bf16 at
B256/224; K3, K4 and K5 in float32, 3xTF32, at B32 and B256), that the
wrappers' partial and split sizes cover every row once, and that calls on
the CPU launch nothing. The kernels themselves run only on the card
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
ROUTES = {"bf16_sm90", "bf16_ragged", "f32_sm90", "f32"}   # K3, K4, K5
TENSOR_CORE_LIBS = ["fused_matmul_sm90", "fused_conv_sm90", "fused_chain_sm90",
                    "fused_matmul_tf32_sm90", "fused_chain_tf32_sm90",
                    "fused_conv_tf32_sm90", "flash_fwd_tf32_sm90",
                    "flash_bwd_tf32_sm90", "paged_attention_sm90"]

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
    tensor-core sources, other bf16 shapes to the CUDA-core ones; K3 and
    K5 in float32 with multiples of 4, and K4 in float32 with C a multiple
    of 32 and N of 4, go to the 3xTF32 sources, other float32 shapes to the
    CUDA-core ones; every route's library is in the build list with its
    headers."""
    assert fm._ROUTES == {torch.bfloat16: ("bf16_sm90", 8, "bf16_ragged"),
                          torch.float32: ("f32_sm90", 4, "f32")}
    assert fm.route(torch.bfloat16, 64, 256) == "bf16_sm90"
    assert fm.route(torch.bfloat16, 24, 40) == "bf16_sm90"
    assert fm.route(torch.bfloat16, 130, 64) == "bf16_ragged"
    assert fm.route(torch.bfloat16, 64, 70) == "bf16_ragged"
    assert fm.route(torch.float32, 64, 256) == "f32_sm90"
    assert fc.route(torch.float32, 64, 64) == "f32_sm90"
    assert fc.route(torch.float32, 72, 16) == "f32"
    assert fc.route(torch.bfloat16, 64, 64) == "bf16_sm90"
    for table in (fm._FWD_FN, fm._BWD_FN, fc._FWD_FN, fch._FWD_FN,
                  fch._BWD_FN):
        assert set(table) == ROUTES
        assert table["bf16_sm90"][0].endswith("_sm90")
        assert table["bf16_ragged"] == table["f32"]
        for lib, _ in table.values():
            for f in _build.SOURCES[lib]:
                assert (_build.CSRC / f).exists(), f
    for table in (fm._FWD_FN, fm._BWD_FN, fc._FWD_FN, fch._FWD_FN,
                  fch._BWD_FN):
        assert table["f32_sm90"][0].endswith("_tf32_sm90")
    assert fc._FWD_FN["f32_sm90"] == ("fused_conv_tf32_sm90",
                                      "bigdl_fused_conv_tf32_sm90_fwd")
    assert fch._FWD_FN["bf16_sm90"] == ("fused_chain_sm90",
                                        "bigdl_fused_chain_sm90_fwd")
    assert fch._BWD_FN["f32_sm90"] == ("fused_chain_tf32_sm90",
                                       "bigdl_fused_chain_tf32_sm90_bwd")
    assert fch._BWD_FN["f32"] == ("fused_chain", "bigdl_fused_chain_bwd")
    assert fch.route is fm.route      # K5 takes K3's rule over (K, N)
    for name in ("fused_matmul_fwd", "fused_matmul_bwd", "fused_conv_fwd",
                 "fused_chain_fwd", "fused_chain_bwd"):
        assert set(kernels.WRAPPERS[name].launches_by_route) == ROUTES


@pytest.mark.parametrize("k,n", [(64, 256), (4, 4), (20, 36), (132, 68),
                                 (2048, 512), (130, 64), (64, 70), (2, 8),
                                 (7, 9)])
def test_float32_route_rule(k, n):
    """float32: K and N multiples of 4 (rows of 16-byte multiples, as TMA
    needs) take the 3xTF32 route, any other shape the CUDA cores."""
    want = "f32_sm90" if k % 4 == 0 and n % 4 == 0 else "f32"
    assert fm.route(torch.float32, k, n) == want
    assert fch.route(torch.float32, k, n) == want
    assert fm._PART_ROWS[want] == (64 if want == "f32_sm90" else fm._BM)


@pytest.mark.parametrize("lib", TENSOR_CORE_LIBS)
def test_tensor_core_sources_call_no_library(lib):
    """The products are PTX wgmma written out in the core header (bf16
    k16, or tf32 k8 on the 3xTF32 route); the split-K paged attention, a
    bandwidth kernel, does its arithmetic on the CUDA cores over cp.async
    copies; no source or header of the library names a GEMM or conv
    library."""
    for f in _build.SOURCES[lib]:
        text = (_build.CSRC / f).read_text().lower()
        for word in ("cublas", "cudnn", "cutlass/gemm", "cutlass/conv"):
            assert word not in text, (f, word)
    if lib == "paged_attention_sm90":
        core = "".join((_build.CSRC / f).read_text()
                       for f in _build.SOURCES[lib])
        assert "wgmma" not in core and "cp.async.cg.shared.global" in core
        return
    tf32 = lib.endswith("_tf32_sm90")
    header = "fused_gemm_tf32_sm90.cuh" if tf32 else "fused_gemm_sm90.cuh"
    core = "".join((_build.CSRC / f).read_text() for f in _build.SOURCES[lib])
    assert header in _build.SOURCES[lib]
    assert re.search(r"wgmma\.mma_async\.sync\.aligned\.m64n\d+k8\.f32\.tf32"
                     if tf32 else
                     r"wgmma\.mma_async\.sync\.aligned\.m64n\d+k16", core)


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


@pytest.mark.parametrize("k,n", [(64, 64), (512, 512), (32, 40), (96, 36),
                                 (72, 16), (16, 24), (64, 70), (48, 64),
                                 (2048, 4)])
def test_k4_float32_route_rule(k, n):
    """float32 K4: C a multiple of 32 (a 32-deep chunk of the contraction
    is one tap) and N of 4 (TMA rows of 16-byte multiples) take the 3xTF32
    route, any other shape the CUDA cores; partials per route."""
    want = "f32_sm90" if k % 32 == 0 and n % 4 == 0 else "f32"
    assert fc.route(torch.float32, k, n) == want
    assert fm._PART_ROWS[want] == (64 if want == "f32_sm90" else fm._BM)


@pytest.mark.parametrize("batch", [32, 256])
@pytest.mark.parametrize("H,C,N,stride", K4_SHAPES)
def test_resnet50_k4_float32_calls_take_the_3xtf32_route(H, C, N, stride,
                                                         batch):
    """Every K4 call of a float32 ResNet-50 step with fused_conv2 (phase
    7's float32 step, B32 as phase 8, and B256) takes f32_sm90; one
    partial per 64 rows covers every output pixel once; the weight's
    split scratch holds its hi and lo halves."""
    assert fc.route(torch.float32, C, N) == "f32_sm90"
    H2 = -(-H // stride)
    M = batch * H2 * H2
    rows = fm._PART_ROWS["f32_sm90"]
    parts = -(-M // rows)
    assert (parts - 1) * rows < M <= parts * rows
    wsp, extra = fm._wsplit("f32_sm90", 9 * C, N, "cpu")
    assert wsp.numel() == 2 * 9 * C * N and extra == (wsp.data_ptr(),)


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


@pytest.mark.parametrize("M,K,N", [(B // 8 * 56 * 56, 64, 256),
                                   (B // 8 * 56 * 56, 256, 64),
                                   (B // 8 * 7 * 7, 1024, 2048),
                                   (802816, 64, 256), (1568, 2048, 512),
                                   (300, 24, 40), (1, 4, 4), (147, 256, 64),
                                   (129, 20, 36)])
def test_dw_splits_tf32_cover_every_row_once(M, K, N):
    """Splits of 64-row multiples (the two warpgroups take alternate
    32-pixel chunks) that together hold every pixel once, and about one
    block per SM at the large shapes; the wrapper's rule for the 3xTF32
    route."""
    assert fm._TC_SPLITS["f32_sm90"] is fm.dw_splits_tf32
    splits, per = fm.dw_splits_tf32(M, K, N)
    assert per % 64 == 0 and splits >= 1 and per >= 64
    assert (splits - 1) * per < M <= splits * per
    bn = 64 if N <= 64 else 128
    blocks = splits * -(-K // 64) * -(-N // bn)
    if M >= 12544:
        assert fm._SMS // 2 <= blocks <= 2 * fm._SMS


@pytest.mark.parametrize("batch", [32, 256])
@pytest.mark.parametrize("M,K,N", K3_SHAPES)
def test_resnet50_k3_float32_calls_take_the_3xtf32_route(M, K, N, batch):
    """Every K3 call of a float32 ResNet-50 step (phase 8's B32, and
    B256) takes f32_sm90; its partials and dw splits cover every row
    once."""
    M = M // B * batch
    assert fm.route(torch.float32, K, N) == "f32_sm90"
    rows = fm._PART_ROWS["f32_sm90"]
    parts = -(-M // rows)
    assert (parts - 1) * rows < M <= parts * rows
    splits, per = fm.dw_splits_tf32(M, K, N)
    assert per % 64 == 0 and (splits - 1) * per < M <= splits * per


@pytest.mark.parametrize("batch", [32, 256])
@pytest.mark.parametrize("H,K,N", K5_SHAPES)
def test_resnet50_k5_float32_calls_take_the_3xtf32_route(H, K, N, batch):
    M = batch * H * H
    assert fch.route(torch.float32, K, N) == "f32_sm90"
    rows = fm._PART_ROWS["f32_sm90"]
    parts = -(-M // rows)
    assert (parts - 1) * rows < M <= parts * rows
    splits, per = fm.dw_splits_tf32(M, K, N)
    assert per % 64 == 0 and (splits - 1) * per < M <= splits * per


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
    """CPU tensors take the plain versions on every route's shapes (the
    tensor-core rule, 3xTF32 included, and a ragged shape): no launch is
    counted, on any route."""
    kernels.reset_launch_counts()
    assert {"f32_sm90", "bf16_sm90"} <= set(
        kernels.launches_by_route()["fused_chain_bwd"])
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
