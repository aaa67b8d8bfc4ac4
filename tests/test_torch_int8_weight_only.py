"""Port parity: the weight-only int8 GEMV (``int8_matmul``), the wide
weight-only GEMM and its input gradient (``int8_matmul_wide``), the
quantize-in-kernel s8 GEMM (``s8_matmul_qx``) and the weight-only QDense,
against the JAX package with its Pallas kernels in interpret mode (the
backend patched to "tpu" where the JAX code asks for it). On the CPU the
port runs each kernel's plain version."""

import importlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thinkdiff_torch import kernels
from thinkdiff_torch.models.bridge import load_params
from thinkdiff_torch.models.qdense import QDense as TQDense
from thinkdiff_torch.ops import int8_matmul as ti
from thinkdiff_tpu.models.t5 import QDense as JQDense
from thinkdiff_tpu.ops import quant as jq

jim = importlib.import_module("thinkdiff_tpu.ops.int8_matmul")
jt5 = importlib.import_module("thinkdiff_tpu.models.t5")


def _interpret():
    real = jim.pl.pallas_call

    def call(*args, **kwargs):
        kwargs["interpret"] = True
        kwargs.pop("compiler_params", None)
        kwargs.pop("cost_estimate", None)
        return real(*args, **kwargs)

    return mock.patch.object(jim.pl, "pallas_call", call)


def _tpu_backend():
    return mock.patch.object(jax, "default_backend", lambda: "tpu")


def _operands(seed, r, k, n, lead=()):
    rs = np.random.RandomState(seed)
    x = rs.randn(*lead, r, k).astype(np.float32)
    wq = rs.randint(-127, 128, (k, n)).astype(np.int8)
    sc = (rs.rand(n) * 0.01 + 1e-3).astype(np.float32)
    return x, wq, sc


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("r,k,n", [(1, 256, 384), (8, 512, 1152),
                                   (32, 256, 384)])
def test_int8_matmul_matches_pallas(r, k, n, dtype):
    """f32: the same integer-valued products summed in another order (1e-4,
    the JAX test's tolerance). bf16 x and output: the same bf16 inputs, the
    f32 sums rounded to bf16 once on each side (one bf16 ulp)."""
    x, wq, sc = _operands(0, r, k, n)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    with _interpret():
        want = np.asarray(jim.int8_matmul(jnp.asarray(x, jdt), jnp.asarray(wq),
                                          jnp.asarray(sc)), np.float32)
    tx = torch.from_numpy(x).to(tdt)
    got = ti.int8_matmul(tx, torch.from_numpy(wq), torch.from_numpy(sc))
    assert got.dtype == tdt and got.shape == (r, n)
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    else:
        _, e = np.frexp(np.maximum(np.abs(want), 2.0 ** -126))
        assert (np.abs(got - want) <= np.ldexp(1.0, e - 8)).all()


def test_int8_matmul_leading_dims_and_out_dtype():
    x, wq, sc = _operands(1, 3, 128, 256, lead=(2,))
    with _interpret():
        want = np.asarray(jim.int8_matmul(jnp.asarray(x), jnp.asarray(wq),
                                          jnp.asarray(sc),
                                          out_dtype=jnp.bfloat16), np.float32)
    got = ti.int8_matmul(torch.from_numpy(x), torch.from_numpy(wq),
                         torch.from_numpy(sc), out_dtype=torch.bfloat16)
    assert got.shape == (2, 3, 256) and got.dtype == torch.bfloat16
    _, e = np.frexp(np.maximum(np.abs(want), 2.0 ** -126))
    assert (np.abs(got.float().numpy() - want) <= np.ldexp(1.0, e - 8)).all()


@pytest.mark.parametrize("k,n", [(100, 96), (128, 40), (24, 32)])
def test_weight_only_kernels_refuse_unaligned_shapes(k, n):
    """The check every CUDA-bound weight-only call makes before launching:
    K and N multiples of 16, else a ValueError naming the shape (the kernel
    never falls back to the plain version)."""
    wq = torch.zeros((k, n), dtype=torch.int8)
    for name in ("int8_matmul", "int8_matmul_wide_fwd", "s8_matmul_qx"):
        with pytest.raises(ValueError, match=f"K={k} and N={n}"):
            ti._check_int8_operands(name, k, wq, torch.ones(n))
    ti._check_int8_operands("int8_matmul", 128, torch.zeros(
        (128, 48), dtype=torch.int8), torch.ones(48))
    with pytest.raises(TypeError):
        ti._check_int8_operands("int8_matmul", 128, torch.zeros(
            (128, 48), dtype=torch.int16), torch.ones(48))


# the GEMV's plan at the flan-t5-xxl decoder's shapes (q/k/v/o and cross
# q/o, wi_0/wi_1, wo, lm_head), ragged N and K, and tiny shapes; an H100's
# 132 SMs, an H100 PCIe's 114, a smaller card's 78
GEMV_SHAPES = [(4096, 4096), (4096, 10240), (10240, 4096), (4096, 32128),
               (64, 48), (512, 16), (1040, 4112)]


def _gemv_units(k, n, block_n, per, ctas):
    """The work of each CTA under a GEMV plan, as the kernel walks it
    (csrc/int8_gemv.cu: units K range by K range, column tile fastest, CTA
    c taking [c U / C, (c + 1) U / C)): a list per CTA of (column tile,
    first stage, end stage) units."""
    steps = -(-k // (ti.GEMV_STAGE_BYTES // block_n))
    tiles = -(-n // block_n)
    units = tiles * -(-steps // per)
    return [[(u % tiles, (u // tiles) * per, min(steps, (u // tiles + 1) * per))
             for u in range(c * units // ctas, (c + 1) * units // ctas)]
            for c in range(ctas)]


@pytest.mark.parametrize("sms", [132, 114, 78])
@pytest.mark.parametrize("k,n", GEMV_SHAPES)
@pytest.mark.parametrize("r", [1, 16, 17, 32])
def test_gemv_plan_covers_k_once_and_balances_the_sms(r, k, n, sms):
    """Every stage of K of every column tile is in exactly one unit, no
    unit or launched CTA is empty, and the busiest SM streams no more than
    the mean over the SMs plus one unit."""
    block_n, per, stages, ctas = ti.gemv_plan(r, k, n, sms)
    assert block_n in ti.GEMV_BLOCKS
    steps = -(-k // (ti.GEMV_STAGE_BYTES // block_n))
    tiles = -(-n // block_n)
    work = _gemv_units(k, n, block_n, per, ctas)
    assert 1 <= ctas <= sms and len(work) == ctas
    covered = np.zeros((tiles, steps), np.int64)
    for units in work:
        assert units
        for tile, k0, k1 in units:
            assert k0 < k1 <= steps and k1 - k0 <= per
            covered[tile, k0:k1] += 1
    assert (covered == 1).all()
    busiest = max(sum(k1 - k0 for _, k0, k1 in units) for units in work)
    assert busiest <= tiles * steps / sms + per
    assert ti.gemv_smem(r, False, stages, block_n) <= ti.SMEM_LIMIT


@pytest.mark.parametrize("f32", [False, True])
@pytest.mark.parametrize("r", [1, 16, 17, 32])
@pytest.mark.parametrize("k,n", [(4096, 4096), (4096, 32128)])
def test_gemv_plan_fits_with_the_deepest_ring(k, n, r, f32):
    """The ring is as deep as shared memory allows, and at least 3 stages:
    the 32 KB of weight in flight an SM needs."""
    block_n, _, stages, _ = ti.gemv_plan(r, k, n, 132, f32)
    assert ti.gemv_smem(r, f32, stages, block_n) <= ti.SMEM_LIMIT
    assert (stages == ti.GEMV_MAX_STAGES
            or ti.gemv_smem(r, f32, stages + 1, block_n) > ti.SMEM_LIMIT)
    assert (stages - 1) * ti.GEMV_STAGE_BYTES >= 32 * 1024


@pytest.mark.parametrize("r,k,n,block_n,splits,ctas", [
    (8, 4096, 4096, 32, 1, 128),     # q/k/v/o: 128 narrow tiles, no split
    (32, 4096, 4096, 32, 1, 128),
    (8, 10240, 4096, 32, 1, 128),    # wo
    (8, 4096, 32128, 128, 1, 132),   # lm_head: 251 wide tiles fill the SMs
    (1, 4096, 10240, 32, 1, 132),    # wi: 320 narrow tiles, 3 or 2 a CTA
    (32, 4096, 10240, 32, 1, 132),
    (8, 10240, 1024, 32, 4, 128),    # 32 tiles: K split to fill the SMs
])
def test_gemv_plan_at_the_t5_shapes(r, k, n, block_n, splits, ctas):
    got_bn, per, _, got_ctas = ti.gemv_plan(r, k, n, 132)
    steps = -(-k // (ti.GEMV_STAGE_BYTES // got_bn))
    assert (got_bn, -(-steps // per), got_ctas) == (block_n, splits, ctas)


# the wide kernels' table: (rows, contraction, output columns, input
# gradient): the flan-t5-xxl FFN at bench.py's 1024 training rows, both
# halves, and lvlm-text's cross-attention kv_fused over 411 rows; then
# ragged row counts
WIDE_SMS = 132  # an H100's SMs
WIDE_TABLE = [(1024, 4096, 10240, False), (1024, 10240, 4096, False),
              (1024, 10240, 4096, True), (1024, 4096, 10240, True),
              (411, 4096, 8192, False)]
WIDE_RAGGED = [(1, 4096, 10240, False), (33, 4096, 10240, False),
               (1, 10240, 4096, True), (33, 10240, 4096, True),
               (1000, 1552, 4112, False), (1000, 4112, 1552, True)]


@pytest.mark.parametrize("f32", [False, True], ids=["bf16", "f32"])
@pytest.mark.parametrize("r,k,n,bwd", WIDE_TABLE + WIDE_RAGGED)
def test_wide_plan_fits_with_the_deepest_ring(r, k, n, bwd, f32):
    """A 128 or 256 block whose ring fits the block's shared memory, as
    deep as fits (2-8); the input gradient of f32 g takes 128 (its 256
    units leave no room for two stages). f32 x is rounded to bf16 before
    the forward, which then plans as bf16."""
    g32 = f32 and bwd
    block, stages = ti.wide_plan(r, k, n, WIDE_SMS, g32, bwd)
    assert block in (128, 256)
    assert 2 <= stages <= ti.WIDE_MAX_STAGES
    assert ti.wide_smem(block, stages, bwd, g32) <= ti.SMEM_LIMIT
    assert (stages == ti.WIDE_MAX_STAGES
            or ti.wide_smem(block, stages + 1, bwd, g32) > ti.SMEM_LIMIT)
    if g32:
        assert block == 128
        assert ti.wide_smem(256, 2, True, True) > ti.SMEM_LIMIT


@pytest.mark.parametrize("r,k,n,bwd,plan,units", [
    (1024, 4096, 10240, False, (256, 4), 320),
    (1024, 10240, 4096, False, (256, 4), 128),
    (1024, 4096, 10240, True, (128, 3), 320),
    (1024, 10240, 4096, True, (128, 3), 128),
    (411, 4096, 8192, False, (256, 4), 128),
    (1, 4096, 10240, False, (128, 8), 80),
    (33, 4096, 10240, False, (128, 8), 80),
    (1024, 1024, 1552, False, (128, 8), 104)])
def test_wide_plan_at_the_table_shapes(r, k, n, bwd, plan, units):
    """256-row units where 128-row ones would take more waves: at R1024
    (320 units, 2.4 waves of 132 SMs, against 640 in 4.8; or 128, 97% of
    one) and at R411 (128 units against 256 in two waves); 128-row units
    where both take one wave (R1, R33, and R1024 over N 1552: 52 or 104
    units), which costs half the products at more than half the time. The
    input gradient's unit is 128 rows x 256 columns at every shape."""
    assert ti.wide_plan(r, k, n, WIDE_SMS, False, bwd) == plan
    block = plan[0]
    assert -(-r // block) * -(-n // (256 if bwd else 128)) == units


def test_wide_smem_is_the_kernel_layout():
    """WideTile::smem: forward 256 rows, 4 stages of x (32 KB) and the int8
    weight tile (8 KB), two 32 KB staging tiles; input gradient 128 rows x
    256 columns, 3 stages of g (16 KB, f32 32 KB), two weight tiles and a
    1 KB slot of scales, three converted g tiles (16 KB), two 32 KB staging
    tiles; the full and empty barriers of the stages and the converted
    tiles' empty ones; 1024 B of alignment. f32 g fits two stages."""
    assert ti.wide_smem(256, 4) == 4 * (32768 + 8192) + 2 * 32768 + 8 * 8 + 1024
    assert ti.wide_smem(128, 3, True) == (3 * (16384 + 16384 + 1024)
                                          + 3 * 16384 + 2 * 32768
                                          + 9 * 8 + 1024)
    assert ti.wide_smem(128, 2, True, True) == (2 * (32768 + 16384 + 1024)
                                                + 3 * 16384 + 2 * 32768
                                                + 7 * 8 + 1024)
    assert ti.wide_smem(128, 3, True, True) > ti.SMEM_LIMIT
    assert ti.wide_smem(128, 4, True) > ti.SMEM_LIMIT


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_matmul_wide_forward_and_grad_match_pallas(dtype):
    """Forward and x's gradient through autograd against the JAX custom_vjp
    with its Pallas kernels: within 2e-2 of the largest element (the JAX
    test's tolerance; both round x, and g * scale, to bf16)."""
    x, wq, sc = _operands(2, 96, 256, 384, lead=(3,))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jx = jnp.asarray(x, jdt)
    with _interpret(), _tpu_backend():
        want = jim.int8_matmul_wide(jx, jnp.asarray(wq), jnp.asarray(sc))
        wgrad = jax.grad(lambda a: jnp.sum(jim.int8_matmul_wide(
            a, jnp.asarray(wq), jnp.asarray(sc)).astype(jnp.float32) ** 2))(jx)
    want, wgrad = (np.asarray(a, np.float32) for a in (want, wgrad))
    tx = torch.tensor(x, dtype=tdt, requires_grad=True)
    tw, ts = torch.from_numpy(wq), torch.from_numpy(sc)
    y = ti.int8_matmul_wide(tx, tw, ts)
    assert y.dtype == tdt and y.shape == (3, 96, 384)
    (grad,) = torch.autograd.grad((y.float() ** 2).sum(), tx)
    assert grad.dtype == tdt
    np.testing.assert_allclose(y.detach().float().numpy(), want, rtol=0,
                               atol=2e-2 * np.abs(want).max())
    np.testing.assert_allclose(grad.float().numpy(), wgrad, rtol=0,
                               atol=2e-2 * np.abs(wgrad).max())
    assert not tw.requires_grad and not ts.requires_grad


def test_int8_matmul_wide_plain_keeps_the_kernel_rounding():
    """The plain forward rounds x to bf16 and the plain backward rounds
    g * scale to bf16 before the product, as the Pallas kernels do: at f32
    the port equals the JAX kernels (interpret mode) to f32 summation order,
    not only to the 2e-2 tolerance."""
    x, wq, sc = _operands(3, 64, 128, 256)
    g = np.random.RandomState(4).randn(64, 256).astype(np.float32)
    with _interpret():
        want = np.asarray(jim._int8_matmul_wide_fwd(
            jnp.asarray(x), jnp.asarray(wq), jnp.asarray(sc), jnp.float32))
        want_dx = np.asarray(jim._int8_matmul_wide_bwd(
            jnp.asarray(g), jnp.asarray(wq), jnp.asarray(sc), jnp.float32))
    got = ti.int8_matmul_wide_fwd(torch.from_numpy(x), torch.from_numpy(wq),
                                  torch.from_numpy(sc)).numpy()
    got_dx = ti.int8_matmul_wide_bwd(torch.from_numpy(g), torch.from_numpy(wq),
                                     torch.from_numpy(sc), torch.float32).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_dx, want_dx, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("m,k,n,dtype", [(96, 256, 384, "float32"),
                                         (33, 128, 128, "float32"),
                                         (64, 384, 256, "bfloat16")])
def test_s8_matmul_qx_bit_identical(m, k, n, dtype):
    """Quantize-in-kernel: bit for bit the pre-pass chain the JAX test holds
    it to (_absmax_quant_rows, then the Pallas _s8_fwd_kernel), in the JAX
    package and in the port; and within the JAX test's 1e-5 of the Pallas
    _s8_fwd_qx_kernel in interpret mode, where XLA turns the kernel's
    ``amax / 127`` into ``amax * (1 / 127)`` and moves some rows' scale by
    one ulp (6 of 96 rows at this seed), so that one is not bit for bit."""
    rs = np.random.RandomState(11)
    x = rs.randn(m, k).astype(np.float32)
    x[1] = 0.0                                       # the 1e-30 scale floor
    x[2, :4] = [127.0, 0.5, -1.5, 2.5]               # exact halves at s = 1
    x[2, 4:] = 0.0
    wq = rs.randint(-127, 128, (k, n)).astype(np.int8)
    sc = (rs.rand(n) * 0.01 + 1e-3).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jx = jnp.asarray(x, jdt)
    with _interpret():
        chain = np.asarray(jim._s8_matmul_fused(
            *jq._absmax_quant_rows(jx), jnp.asarray(wq), jnp.asarray(sc),
            jnp.float32))
        qx = np.asarray(jim._s8_matmul_fused_qx(
            jx, jnp.asarray(wq), jnp.asarray(sc), jnp.float32))
    tx = torch.from_numpy(x).to(tdt)
    got = ti.s8_matmul_qx(tx, torch.from_numpy(wq), torch.from_numpy(sc),
                          torch.float32)
    np.testing.assert_array_equal(got.numpy(), chain)
    np.testing.assert_allclose(got.numpy(), qx, rtol=1e-5, atol=1e-5)
    from thinkdiff_torch.ops.quant import _absmax_quant_rows

    xq, sx = _absmax_quant_rows(tx)
    port_chain = ti.s8_matmul(xq, sx, torch.from_numpy(wq),
                              torch.from_numpy(sc), torch.float32)
    assert torch.equal(got, port_chain)


@pytest.mark.parametrize("r,k,n", [(96, 256, 384), (33, 128, 128),
                                   (1024, 8192, 4096), (1024, 4096, 12288),
                                   (8, 4096, 100), (8, 200, 256),
                                   (1024, 4096, 20480)])
def test_s8_qx_supported_matches_jax(r, k, n):
    assert ti.s8_qx_supported(r, k, n) == jim.s8_qx_supported(r, k, n)


@pytest.mark.parametrize("rows", [1, 8, 32, 33])
def test_weight_only_qdense_matches_jax(rows):
    """The weight-only QDense at <= 32 rows (the GEMV: Pallas under the
    patched backend, the port's plain int8_matmul on the CPU) and at 33
    (both packages' wide branch: the product in the layer dtype, then the
    scale), f32, with a bias."""
    rs = np.random.RandomState(5)
    k, n = 256, 384
    x = rs.randn(rows, k).astype(np.float32)
    qw = jq.quantize_weight(rs.randn(k, n).astype(np.float32) * 0.05)
    params = {"kernel_q": qw["q"], "kernel_scale": qw["scale"],
              "bias": rs.randn(n).astype(np.float32) * 0.1}
    called = []
    real = jim.int8_matmul

    def spy(*a, **kw):
        called.append(True)
        return real(*a, **kw)

    with _interpret(), _tpu_backend(), mock.patch.object(
            jim, "int8_matmul", spy):
        want = np.asarray(JQDense(n, quant=True, use_bias=True).apply(
            {"params": jax.tree.map(jnp.asarray, params)}, jnp.asarray(x)))
    assert bool(called) == (rows <= 32)
    layer = load_params(TQDense(k, n, torch.float32, True, True), params)
    assert set(dict(layer.named_buffers())) == {"kernel_q", "kernel_scale"}
    ran = []
    with mock.patch("thinkdiff_torch.models.qdense.int8_matmul",
                    lambda *a, **kw: ran.append(1) or ti.int8_matmul(*a, **kw)):
        got = layer(torch.from_numpy(x)).numpy()
    assert bool(ran) == (rows <= 32)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_cpu_wrappers_launch_nothing():
    kernels.reset_launch_counts()
    x, wq, sc = _operands(6, 4, 64, 32)
    tx = torch.from_numpy(x).requires_grad_(True)
    args = (torch.from_numpy(wq), torch.from_numpy(sc))
    ti.int8_matmul(tx.detach(), *args)
    ti.int8_matmul_wide(tx, *args).sum().backward()
    ti.s8_matmul_qx(tx.detach(), *args)
    assert all(v == 0 for v in kernels.launch_counts().values())
