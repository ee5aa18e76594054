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
                    "flash_bwd_tf32_sm90", "paged_attention_sm90",
                    "fused_matmul", "fused_chain", "fused_conv"]
# the libraries of K3's, K5's and K4's ragged routes (f32, bf16_ragged): the
# 3xTF32 and bf16 cores with their ragged load / store policy
RAGGED_LIBS = ("fused_matmul", "fused_chain", "fused_conv")

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
    aligned tensor-core sources, other bf16 shapes to the ragged ones; K3
    and K5 in float32 with multiples of 4, and K4 in float32 with C a
    multiple of 32 and N of 4, go to the aligned 3xTF32 sources, other
    float32 shapes to the ragged ones (one library a kernel for both
    dtypes); every route's library is in the build list with its
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
    needs) take the aligned 3xTF32 route, any other shape the ragged one;
    both are the 3xTF32 core, one partial of the column sums per 64 rows
    (a consumer warpgroup's)."""
    want = "f32_sm90" if k % 4 == 0 and n % 4 == 0 else "f32"
    assert fm.route(torch.float32, k, n) == want
    assert fch.route(torch.float32, k, n) == want
    assert fm._PART_ROWS[want] == 64


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
    tf32 = lib.endswith("_tf32_sm90") or lib in RAGGED_LIBS
    header = "fused_gemm_tf32_sm90.cuh" if tf32 else "fused_gemm_sm90.cuh"
    core = "".join((_build.CSRC / f).read_text() for f in _build.SOURCES[lib])
    assert header in _build.SOURCES[lib]
    assert re.search(r"wgmma\.mma_async\.sync\.aligned\.m64n\d+k8\.f32\.tf32"
                     if tf32 else
                     r"wgmma\.mma_async\.sync\.aligned\.m64n\d+k16", core)
    if lib in RAGGED_LIBS:      # float32 on 3xTF32, bf16 on bf16 wgmma
        assert re.search(r"wgmma\.mma_async\.sync\.aligned\.m64n\d+k16\.f32"
                         r"\.bf16", core)


@pytest.mark.parametrize("lib,ops", [
    ("fused_matmul", ("XHatF<true>", "DzEffF<true>", "DxEpi2<float, true>",
                      "gemm_dw<false, true>", "XHatA<1, true>",
                      "DzEffA<true>", "DxEpi2<bf16, true>")),
    ("fused_chain", ("ResidF<true>", "DzEffF<true>",
                     "ChainDxEpi2<float, true>", "gemm_dw<true, true>",
                     "ResidA<true>", "DzEffA<true>",
                     "ChainDxEpi2<bf16, true>")),
    ("fused_conv", ("struct XHatConvFR", "gemm<true>(whi, wlo",
                    "split_taps_kernel", "struct XHatConvA : XHatA<9>",
                    "gemm_rs<128, 1, true>(wpad", "pad_taps_kernel"))])
def test_ragged_entries_run_the_tensor_core_cores(lib, ops):
    """fused_matmul.cu, fused_chain.cu and fused_conv.cu (the f32 and
    bf16_ragged routes) instantiate the cores' operands, epilogues and
    weight gradient with the ragged policy (RG = true) in both dtypes (K4:
    its ragged 3x3 gathers over the 3xTF32 and bf16 cores, the tap-padded
    weight preparation); the CUDA-core GEMM of fused_gemm.cuh and its
    functors (XHat, DzEff, Resid, Im2col, ColsOf, RowsOf, StoreZ) are gone
    from every source and header."""
    src = (_build.CSRC / _build.SOURCES[lib][0]).read_text()
    for op in ops:
        assert op in src, (lib, op)
    for gone in ("XHat<", "DzEff<", "Resid<", "ColsOf<", "RowsOf<",
                 "StoreSplit", "Im2col", "StoreZ<"):
        assert gone not in src, (lib, gone)
    gemm = (_build.CSRC / "fused_gemm.cuh").read_text()
    for gone in ("Im2col", "ColsOf", "StoreZ", "Tiles", "gemm_kernel",
                 "load_tile"):
        assert gone not in gemm, gone
    assert "sum_rows_kernel" in gemm and "affine" in gemm


@pytest.mark.parametrize("k,n", [(63, 50), (64, 256), (6, 24), (130, 70),
                                 (1, 1), (255, 63), (2048, 512), (33, 17)])
def test_weight_scratch_sizes_per_route(k, n):
    """The weight's scratch of each route's forward and backward: the
    aligned 3xTF32 route its hi and lo halves (2 K N); the ragged float32
    route B's rows zero-padded to whole 32-deep stages (the forward's B is
    w^T, N rows of K; dx's is w, K rows of N); bf16_ragged w's rows padded
    to a multiple of 8 (K x N8 bf16 in float32 elements), the same for both
    products; none on bf16_sm90."""
    up = lambda v, q: -(-v // q) * q
    want = {("f32_sm90", True): 2 * k * n, ("f32_sm90", False): 2 * k * n,
            ("f32", True): 2 * n * up(k, 32), ("f32", False): 2 * k * up(n, 32),
            ("bf16_ragged", True): -(-k * up(n, 8) // 2),
            ("bf16_ragged", False): -(-k * up(n, 8) // 2),
            ("bf16_sm90", True): 0, ("bf16_sm90", False): 0}
    for (rt, fwd), elems in want.items():
        assert fm.wsplit_elems(rt, k, n, fwd) == elems, (rt, fwd)
        t, extra = fm._wsplit(rt, k, n, "cpu", fwd)
        if rt == "bf16_sm90":
            assert t is None and extra == ()
        else:
            assert t.numel() == elems and extra == (t.data_ptr(),)
    assert 2 * want[("bf16_ragged", True)] >= k * up(n, 8)   # bf16 elements


@pytest.mark.parametrize("c,n", [(50, 50), (48, 48), (20, 13), (7, 13),
                                 (64, 64), (16, 24), (1, 1), (72, 16)])
def test_k4_weight_scratch_is_the_tap_padded_weight(c, n):
    """K4's weight scratch per route: f32_sm90 the hi and lo halves of w^T
    (N rows of 9 C); the ragged float32 route the same with each tap's
    channels padded to C rounded up to 32, so a 32-deep chunk of the
    contraction is one tap (N rows of 9 Cp); bf16_ragged a bf16 copy of 9
    Cp rows (Cp: C rounded up to 8, so a unit of 8 channels is in one tap)
    of N rounded up to 8, in float32 elements; none on bf16_sm90. Every
    size is weight-sized: at most 2 x 32 / C + ... times the weight, never
    a multiple of the activations."""
    up = lambda v, q: -(-v // q) * q
    want = {"f32_sm90": 2 * 9 * c * n, "f32": 2 * n * 9 * up(c, 32),
            "bf16_ragged": -(-9 * up(c, 8) * up(n, 8) // 2), "bf16_sm90": 0}
    for rt, elems in want.items():
        assert fc.wsplit_elems(rt, c, n) == elems, rt
    assert want["f32"] >= want["f32_sm90"]
    assert want["f32"] == want["f32_sm90"] or c % 32
    assert 2 * want["bf16_ragged"] >= 9 * up(c, 8) * up(n, 8)
    # the padding a tap costs: 1.28x at C = 50 and 2x at C = 16 in float32
    assert fc.wsplit_elems("f32", 50, n) / fc.wsplit_elems(
        "f32_sm90", 50, n) == 64 / 50
    assert fc.wsplit_elems("f32", 16, n) == 2 * fc.wsplit_elems(
        "f32_sm90", 16, n)


@pytest.mark.parametrize("rt,M,K,N", [
    ("f32", 100352, 63, 255), ("f32", 100352, 255, 63), ("f32", 129, 63, 50),
    ("f32", 1, 1, 1), ("f32", 300, 6, 24), ("f32", 3136 * 32, 50, 200),
    ("bf16_ragged", 802816, 63, 255), ("bf16_ragged", 802816, 255, 63),
    ("bf16_ragged", 129, 63, 50), ("bf16_ragged", 1, 1, 1),
    ("bf16_ragged", 200704, 200, 50), ("bf16_ragged", 77, 6, 24)])
def test_ragged_dw_splits_cover_every_row_once(rt, M, K, N):
    """The ragged routes split dw as their cores do (two partials a
    split): float32 in 64-row multiples (dw_splits_tf32), bf16 in 128-row
    multiples (dw_splits_sm90), every pixel in exactly one split, about one
    block per SM at the large shapes."""
    split = fm._TC_SPLITS[rt]
    assert split is (fm.dw_splits_tf32 if rt == "f32" else fm.dw_splits_sm90)
    quantum = 64 if rt == "f32" else 128
    splits, per = split(M, K, N)
    assert per % quantum == 0 and splits >= 1
    assert (splits - 1) * per < M <= splits * per
    bn = 64 if N <= 64 else 128
    if M >= 12544:
        assert splits * -(-K // 64) * -(-N // bn) <= 2 * fm._SMS


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_resnet50_routes_unchanged_and_width_50_chain_ragged(dt):
    """route() sends every ResNet-50 K3 and K5 shape to the aligned route
    of its dtype and the width-50 bottleneck chain's calls (conv1 ragged in
    N, conv3 in K, the junction's next conv1 in N) to the ragged one; the
    width-48 chain stays aligned."""
    aligned = {torch.float32: "f32_sm90", torch.bfloat16: "bf16_sm90"}[dt]
    ragged = {torch.float32: "f32", torch.bfloat16: "bf16_ragged"}[dt]
    for _, K, N in K3_SHAPES:
        assert fm.route(dt, K, N) == aligned
    for _, K, N in K5_SHAPES:
        assert fch.route(dt, K, N) == aligned
    for w, want in ((chip_smoke.CHAIN_RAGGED, ragged),
                    (chip_smoke.CHAIN_ALIGNED, aligned)):
        nin, nout = 2 * w, 4 * w
        for k, n in ((nin, w), (w, nout), (nout, w)):
            assert fm.route(dt, k, n) == want, (w, k, n)


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
    is one tap) and N of 4 (TMA rows of 16-byte multiples) take the aligned
    3xTF32 route, any other shape the ragged one (the same core, per-tap
    padding); one partial per 64 rows on either (the cores' kPartRows)."""
    want = "f32_sm90" if k % 32 == 0 and n % 4 == 0 else "f32"
    assert fc.route(torch.float32, k, n) == want
    assert fc._PART_ROWS[want] == 64
    assert fc._PART_ROWS == dict.fromkeys(
        ("bf16_sm90", "bf16_ragged", "f32_sm90", "f32"), 64)


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
    assert fc.wsplit_elems("f32_sm90", C, N) == 2 * 9 * C * N


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
