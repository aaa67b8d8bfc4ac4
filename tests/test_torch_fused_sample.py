"""Port parity: thinkdiff_torch.ops.fused_sample against the JAX package's
fused lm_head + sampler (its Pallas kernel in interpret mode, noise off),
the Gumbel transform, and the port's counter-based noise."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from thinkdiff_torch.ops import fused_sample as tfs
from thinkdiff_tpu.ops import fused_sample as jfs


def _quantize(w):
    amax = np.abs(w).max(axis=0)
    scale = np.where(amax == 0, 1.0, amax / 127.0).astype(np.float32)
    q = np.clip(np.round(w / scale[None]), -127, 127).astype(np.int8)
    return q, scale


def _both(x, q, scale, blocked, **pack_kw):
    """Ids from the JAX kernel (interpret, noise off) and from the port."""
    jpack = jfs.pack_lm_head(q, scale, **pack_kw)
    want = np.asarray(jfs.fused_lm_sample(
        jnp.asarray(x), jpack, jnp.asarray(blocked), jnp.zeros(2, jnp.int32),
        temperature=0.0, noise=False, interpret=True))
    tpack = tfs.pack_lm_head(torch.from_numpy(q), torch.from_numpy(scale),
                             **pack_kw)
    got = tfs.fused_lm_sample(
        torch.from_numpy(x), tpack, torch.from_numpy(blocked),
        torch.zeros(2, dtype=torch.int32), temperature=0.0, noise=False)
    return got.numpy(), want


@pytest.mark.parametrize("input_scale", [False, True])
def test_pack_lm_head_identical(input_scale):
    rs = np.random.RandomState(0)
    d, v = 64, 300
    q, scale = _quantize(rs.randn(d, v).astype(np.float32))
    iscale = (rs.rand(d).astype(np.float32) + 0.5) if input_scale else None
    want = jfs.pack_lm_head(q, scale, input_scale=iscale, eos_ids=[5, 299, 400])
    got = tfs.pack_lm_head(torch.from_numpy(q), torch.from_numpy(scale),
                           input_scale=iscale, eos_ids=[5, 299, 400])
    for key in ("q", "scale", "inv_input", "pad_bias", "eos_bias"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]),
                                      err_msg=key)
    assert (got["block_n"], got["vocab"]) == (want["block_n"], want["vocab"])
    # the JAX-layout q is a view of the kernel's (Vp, D) storage
    assert got["qt"].shape == (512, d) and got["qt"].is_contiguous()
    assert got["q"].data_ptr() == got["qt"].data_ptr()


def test_greedy_with_eos_blocking_and_padding_matches_jax():
    rs = np.random.RandomState(0)
    b, d, v = 16, 128, 300
    q, scale = _quantize(rs.randn(d, v).astype(np.float32) * 0.05)
    x = rs.randn(b, d).astype(np.float32)
    blocked = np.zeros(b, np.float32)
    blocked[:5] = 1.0
    got, want = _both(x, q, scale, blocked, eos_ids=[5, 7])
    np.testing.assert_array_equal(got, want)
    assert not np.isin(got[:5], [5, 7]).any()


def test_first_occurrence_tie_break_matches_jax():
    """Duplicate maxima in three vocab blocks resolve to the lowest column."""
    b, d, v = 8, 128, 384
    rs = np.random.RandomState(1)
    w = rs.randn(d, v).astype(np.float32) * 0.01
    for c in (7, 130, 260):
        w[:, c] = w[:, 7] + (10.0 if c == 7 else 0.0)
    w[:, 130] = w[:, 7]
    w[:, 260] = w[:, 7]
    q, scale = _quantize(w)
    for c in (130, 260):
        q[:, c], scale[c] = q[:, 7], scale[7]
    x = np.abs(rs.randn(b, d)).astype(np.float32)
    got, want = _both(x, q, scale, np.zeros(b, np.float32), block_n=128)
    np.testing.assert_array_equal(got, want)
    assert (got == 7).all()


def test_tiny_vocab_block_shrink_matches_jax():
    rs = np.random.RandomState(2)
    b, d, v = 8, 64, 100
    q, scale = _quantize(rs.randn(d, v).astype(np.float32))
    tpack = tfs.pack_lm_head(torch.from_numpy(q), torch.from_numpy(scale))
    assert tpack["block_n"] == 128 and tpack["q"].shape == (1, d, 128)
    got, want = _both(rs.randn(b, d).astype(np.float32), q, scale,
                      np.zeros(b, np.float32))
    np.testing.assert_array_equal(got, want)
    assert (got < v).all()


def _uniform_jax(bits):
    top24 = np.asarray(bits >> np.uint32(8)).astype(np.int32)
    return (jnp.asarray(top24).astype(jnp.float32) + 0.5) * (2.0 ** -24)


def test_bits_to_gumbel_matches_jax():
    """The uniform u = (top 24 bits + 0.5) * 2^-24 is bit-identical to the
    JAX transform's; the two f32 logs after it are each within an ulp of
    XLA's own (XLA's CPU log is not correctly rounded, so the last bit can
    differ), which bounds |g_port - g_jax| by 4e-7 + 2 ulp(g)."""
    rs = np.random.RandomState(3)
    bits = np.concatenate([
        rs.randint(0, 2 ** 32, size=200_000, dtype=np.uint64).astype(np.uint32),
        np.array([0, 1, 255, 256, 2 ** 31, 2 ** 32 - 257], np.uint32)])
    bits = bits[(bits >> 8) != 2 ** 24 - 1]  # the repaired pattern, below
    tbits = torch.from_numpy(bits.astype(np.int64))
    u_port = ((tbits >> 8).float() + 0.5) * (2.0 ** -24)
    np.testing.assert_array_equal(u_port.numpy(), np.asarray(_uniform_jax(bits)))
    want = np.asarray(jfs._bits_to_gumbel(jnp.asarray(bits)))
    got = tfs.bits_to_gumbel(tbits).numpy()
    assert np.isfinite(got).all() and np.isfinite(want).all()
    ulp = np.spacing(np.abs(want).astype(np.float32))
    assert (np.abs(got - want) <= 4e-7 + 2 * ulp).all()
    assert np.mean(got == want) > 0.5


def test_bits_to_gumbel_top_pattern_is_finite():
    """Top bits 2^24 - 1: JAX's f32 sum rounds to 2^24, u to 1 and g to
    +inf (a column that wins any argmax, padding and blocked EOS included;
    about 0.9% of 153,600-column rows hold one). The port clamps u below 1:
    a large finite draw, above every other pattern's."""
    top = np.array([0xFFFFFFFF, 0xFFFFFF00], np.uint32)
    assert np.isinf(np.asarray(jfs._bits_to_gumbel(jnp.asarray(top)))).all()
    got = tfs.bits_to_gumbel(torch.from_numpy(top.astype(np.int64)))
    below = tfs.bits_to_gumbel(torch.tensor([0xFFFFFEFF]))
    assert torch.isfinite(got).all() and (got > below).all()


def test_gumbel_noise_is_keyed_on_seed_row_and_column():
    """Counter-based draws: a (row, col) draw does not depend on the shape
    asked for, and another seed gives other draws; the law is Gumbel(0,1)."""
    seed = torch.tensor([12345, -7], dtype=torch.int32)
    g = tfs.gumbel_noise(seed, 64, 3000)
    np.testing.assert_array_equal(tfs.gumbel_noise(seed, 8, 1000).numpy(),
                                  g[:8, :1000].numpy())
    other = tfs.gumbel_noise(torch.tensor([12346, -7], dtype=torch.int32), 8, 100)
    assert (other != g[:8, :100]).float().mean() > 0.99
    flat = g.numpy().ravel()
    assert abs(flat.mean() - 0.57722) < 0.02
    assert abs(flat.var() - np.pi ** 2 / 6) < 0.05


def test_noise_sampling_follows_the_temperature_softmax():
    """noise=True on one fixed row drawn 40,000 times (one seed each):
    the total-variation distance between the draws and softmax(logits / T)
    stays inside the sampling-noise envelope 4 * sqrt(V / (2 pi N))."""
    rs = np.random.RandomState(4)
    d, v, temp, n = 64, 16, 0.6, 40_000
    q, scale = _quantize(rs.randn(d, v).astype(np.float32) * 0.3)
    pack = tfs.pack_lm_head(torch.from_numpy(q), torch.from_numpy(scale))
    x = torch.from_numpy(rs.randn(1, d).astype(np.float32)).repeat(n, 1)
    # one row per draw: the key's row index makes every draw independent
    ids = tfs.fused_lm_sample(x, pack, torch.zeros(n),
                              torch.tensor([99, 1], dtype=torch.int32),
                              temperature=temp, noise=True).numpy()
    xq, sx = tfs._quantize_input(x[:1], pack)
    logits = (xq.double() @ torch.from_numpy(q).double()).float() * sx[:, None] \
        * torch.from_numpy(scale)[None]
    p = torch.softmax(logits[0] / temp, dim=-1).numpy()
    emp = np.bincount(ids, minlength=v)[:v] / n
    tv = 0.5 * np.abs(emp - p).sum()
    assert tv < 4.0 * np.sqrt(v / (2 * np.pi * n)), tv


def test_reference_adds_the_given_noise():
    rs = np.random.RandomState(5)
    d, v, b = 32, 128, 4
    q, scale = _quantize(rs.randn(d, v).astype(np.float32))
    pack = tfs.pack_lm_head(torch.from_numpy(q), torch.from_numpy(scale))
    x = torch.from_numpy(rs.randn(b, d).astype(np.float32))
    noise = torch.full((b, v), -1e9)
    noise[torch.arange(b), torch.tensor([3, 50, 77, 127])] = 1e9
    got = tfs.fused_lm_sample_reference(x, pack, torch.zeros(b),
                                        temperature=0.7, noise=noise)
    assert got.tolist() == [3, 50, 77, 127]


def test_tied_embedding_pack_matches_jax():
    """2B-style tied embeddings: the (V, D) table quantized per token into
    the pack, as the JAX engine's _fused_sampler_pack does it."""
    rs = np.random.RandomState(6)
    emb = (rs.randn(300, 64) * 0.05).astype(np.float32)
    amax = np.abs(emb).max(axis=1)
    scale = np.where(amax == 0, 1.0, amax / 127.0).astype(np.float32)
    q = np.clip(np.round(emb / scale[:, None]), -127, 127).astype(np.int8)
    want = jfs.pack_lm_head(q.T, scale, eos_ids=[7])
    got = tfs.pack_tied_embedding(torch.from_numpy(emb), [7])
    for key in ("q", "scale", "inv_input", "pad_bias", "eos_bias"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]),
                                      err_msg=key)


# ---- the CUDA kernel's host side (csrc/fused_sample.cu): its plan, the
# wrapper's checks and the 64-bit argmax key, on the CPU ----

SMS = 132  # an H100's SMs
_VP_2B = 153600  # the 2B pack's 151936 columns padded to 2048
_VP_7B = 153600  # the 7B's 152064, likewise


@pytest.mark.parametrize("b", [1, 5, 8, 9, 16, 17, 32, 33, 64, 65, 100, 128,
                               129, 200, 256])
@pytest.mark.parametrize("d,vp", [(1536, _VP_2B), (3584, _VP_7B), (64, 512)])
def test_sample_plan_fits_covers_and_fills(b, d, vp):
    """Shared memory within the block's limit, with rings as deep as fit;
    batch tiles that hold the rows (one of B <= 128 at the narrowest wgmma
    width, two of 128 above); every 64-row vocabulary block walked by
    exactly one CTA, the CTAs' shares within one block of each other, every
    CTA with at least one block (two, where there are, with one tile, so
    that both warpgroups work); and as many CTAs as that leaves room for,
    up to one an SM."""
    n, tiles, stages, ctas = tfs.sample_plan(b, d, vp, SMS)
    assert tfs.sample_smem(n, tiles, stages) <= tfs.SMEM_LIMIT
    assert n in tfs.SAMPLE_WIDTHS and 2 <= stages <= tfs.SAMPLE_MAX_STAGES
    assert (stages == tfs.SAMPLE_MAX_STAGES
            or tfs.sample_smem(n, tiles, stages + 1) > tfs.SMEM_LIMIT)
    assert tiles == (1 if b <= 128 else 2) and b <= tiles * n
    assert (n == 8 or n // 2 < b) if tiles == 1 else n == 128
    spans = tfs.sample_blocks((n, tiles, stages, ctas), vp)
    covered = [blk for lo, hi in spans for blk in range(lo, hi)]
    blocks = vp // tfs.SAMPLE_BLOCK
    assert covered == list(range(blocks))
    sizes = [hi - lo for lo, hi in spans]
    least = 2 if tiles == 1 and blocks >= 2 else 1
    assert min(sizes) >= least and max(sizes) - min(sizes) <= 1
    # one CTA more would leave a CTA short of its blocks, or the SMs full
    assert ctas <= SMS and (ctas == SMS or blocks // (ctas + 1) < least)


def test_sample_plan_on_the_main_paths():
    """The gumbel slice's 64 rows at D1536 and lvlm-text's 16 at D3584:
    one batch tile at the batch's own width, rings of seven and eight
    stages, one CTA an SM; 256 rows: two tiles of 128, rings of four."""
    assert tfs.sample_plan(64, 1536, _VP_2B, SMS) == (64, 1, 7, SMS)
    assert tfs.sample_plan(16, 3584, _VP_7B, SMS) == (16, 1, 8, SMS)
    assert tfs.sample_plan(256, 1536, _VP_2B, SMS) == (128, 2, 4, SMS)
    for b, d in ((128, 1536), (64, 3584)):
        assert tfs.sample_plan(b, d, _VP_2B, SMS)[2] >= 4


def _misaligned_rows(b, d, dtype):
    n = b * d
    return torch.zeros(n + 8, dtype=dtype)[1:n + 1].view(b, d)


def _tiny_pack(d=64, v=300):
    rs = np.random.RandomState(9)
    q, scale = _quantize(rs.randn(d, v).astype(np.float32))
    return tfs.pack_lm_head(torch.from_numpy(q), torch.from_numpy(scale))


_SAMPLE_BAD = {
    "x_wrong_d": (lambda pk: (torch.zeros(4, 32), pk), ValueError),
    "x_3d": (lambda pk: (torch.zeros(4, 1, 64), pk), ValueError),
    "x_int": (lambda pk: (torch.zeros(4, 64, dtype=torch.int32), pk),
              TypeError),
    "x_unaligned": (lambda pk: (_misaligned_rows(4, 64, torch.bfloat16), pk),
                    ValueError),
    "d_not_16": (lambda pk: (torch.zeros(4, 40), _tiny_pack(d=40)),
                 ValueError),
    "qt_float": (lambda pk: (torch.zeros(4, 64), dict(pk, qt=pk["qt"].float())),
                 TypeError),
    "qt_strided": (lambda pk: (torch.zeros(4, 64), dict(
        pk, qt=torch.zeros(64, 1024, dtype=torch.int8).t()[:, :64])),
        TypeError),
    "b_4096": (lambda pk: (torch.zeros(4096, 64), pk), ValueError),
}


@pytest.fixture
def no_launch(monkeypatch):
    """Fail where a wrapper reaches the kernel library."""
    from thinkdiff_torch import kernels

    def library():
        raise AssertionError("the wrapper reached the kernel library")

    monkeypatch.setattr(kernels, "library", library)
    before = kernels.launch_counts()
    yield
    assert kernels.launch_counts() == before


@pytest.mark.parametrize("case", sorted(_SAMPLE_BAD))
def test_fused_sample_kernel_wrapper_raises_before_launch(no_launch, case):
    make, err = _SAMPLE_BAD[case]
    x, pack = make(_tiny_pack())
    b = x.shape[0]
    with pytest.raises(err):
        tfs._fused_lm_sample_cuda(x, pack, torch.zeros(b),
                                  torch.zeros(2, dtype=torch.int32), 0.6, True)


def test_sample_plan_refuses_rows_past_a_launch():
    for b in (0, 257):
        with pytest.raises(ValueError):
            tfs.sample_plan(b, 1536, _VP_2B, SMS)


# values around which the key's order is easy to get wrong: ties, -0.0 and
# +0.0, the -1e30 masking bias, the infinities, and Gumbel draws near the
# clamped top (g of the top three uniform patterns)
_TOP_G = tfs.bits_to_gumbel(torch.tensor([0xFFFFFFFF, 0xFFFFFEFF, 0xFFFFFDFF],
                                         dtype=torch.int64)).tolist()
_KEY_ROWS = {
    "ties": [1.5, 3.0, -2.0, 3.0, 3.0, 0.5],
    "signed_zeros": [-0.0, 0.0, -0.0, -1.0],
    "zero_after_negative_zero": [-5.0, -0.0, 0.0],
    "all_masked": [-1e30, -1e30, -1e30],
    "masked_and_live": [-1e30, -7.25, -1e30, -7.25],
    "negatives": [-3.0, -1.0, -1.0000001, -2.0],
    "gumbel_top": _TOP_G + [_TOP_G[0], _TOP_G[1] - 1e-3],
    "subnormals": [1e-45, -1e-45, 0.0, 1e-45],
    "infinities": [-np.inf, 1e38, np.inf, np.inf],
}


@pytest.mark.parametrize("row", sorted(_KEY_ROWS))
def test_argmax_key_orders_as_torch_argmax(row):
    """The largest 64-bit key of a row encodes torch.argmax's column
    (first occurrence), whichever order the keys are combined in; keys
    order first by value, then by the lower column."""
    vals = torch.tensor(_KEY_ROWS[row], dtype=torch.float32)
    keys = [tfs.argmax_key(float(v), c) for c, v in enumerate(vals)]
    want = int(torch.argmax(vals))
    assert tfs.key_column(max(keys)) == want
    assert tfs.key_column(max(reversed(keys))) == want
    for i in range(len(keys)):
        for j in range(len(keys)):
            vi, vj = float(vals[i]), float(vals[j])
            if vi != vj:
                assert (keys[i] > keys[j]) == (vi > vj)
            else:
                assert (keys[i] > keys[j]) == (i < j)


def test_argmax_key_noise_rows_match_torch_argmax():
    """Rows of the plain version's biased, noised logits (keyed Gumbel
    draws, -1e30 padding and EOS masks): the max key is torch.argmax's."""
    seed = torch.tensor([7, -3], dtype=torch.int32)
    g = tfs.gumbel_noise(seed, 16, 600)
    rs = np.random.RandomState(11)
    logits = torch.from_numpy(rs.randn(16, 600).astype(np.float32)) * 2
    logits[:, 500:] = -1e30
    logits[::3, 7] = -1e30
    per = logits / 0.6 + g
    for r in range(16):
        keys = [tfs.argmax_key(float(v), c) for c, v in enumerate(per[r])]
        assert tfs.key_column(max(keys)) == int(torch.argmax(per[r]))


def _shard_packs(q, scale, eos, shards):
    """Each vocabulary shard's pack (its own padding, its EOS columns made
    local) with its first global column."""
    v = q.shape[1]
    out = []
    for s in range(shards):
        lo, hi = s * v // shards, (s + 1) * v // shards
        pack = tfs.pack_lm_head(
            torch.from_numpy(q[:, lo:hi]), torch.from_numpy(scale[lo:hi]),
            eos_ids=[e - lo for e in eos if lo <= e < hi])
        out.append((lo, pack))
    return out


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("noise", [False, True])
def test_shard_keys_reduce_to_the_unsharded_ids(shards, noise):
    """The plain version's vocabulary-shard mode: each shard's int64 argmax
    keys (col0 = its first global column, its own -1e30 padding, its EOS
    columns), reduced with MAX, give the unsharded call's ids, with and
    without noise. Row 0's best value is tied across a shard boundary
    (two identical columns): the lower global column must win."""
    rs = np.random.RandomState(7)
    b, d, v = 12, 64, 600
    w = rs.randn(d, v).astype(np.float32) * 0.05
    x = rs.randn(b, d).astype(np.float32)
    edge = v // shards
    w[:, edge - 1] = w[:, edge] = np.sign(x[0]) * 0.3
    q, scale = _quantize(w)
    eos = [3, edge + 5, v - 1]
    blocked = (np.arange(b) % 3 == 0).astype(np.float32)
    seed2 = torch.tensor([123, 456], dtype=torch.int32)
    kw = dict(temperature=0.6, noise=noise)
    full = tfs.pack_lm_head(torch.from_numpy(q), torch.from_numpy(scale),
                            eos_ids=eos)
    xt, bt = torch.from_numpy(x), torch.from_numpy(blocked)
    want = tfs.fused_lm_sample(xt, full, bt, seed2, **kw)
    if not noise:
        assert int(want[0]) == edge - 1
    keys = torch.stack([
        tfs.fused_lm_sample(xt, pack, bt, seed2, col0=lo, keys=True, **kw)
        for lo, pack in _shard_packs(q, scale, eos, shards)])
    got = tfs.keys_to_ids(keys.amax(dim=0))
    assert torch.equal(got, want)
    # a blocked row's EOS columns (-1e30 in their shards) never win
    assert not ((bt > 0) & torch.isin(got, torch.tensor(eos))).any()


def test_shard_keys_order_as_the_kernel_keys():
    """``argmax_keys`` is ``argmax_key`` with the top bit flipped, so int64
    order is the unsigned keys' order (negative, zero and positive values;
    -0.0 as +0.0)."""
    vals = np.array([-3.5, -0.0, 0.0, 1e-30, 2.0, 2.0, -1e30], np.float32)
    cols = np.array([9, 4, 7, 1, 5, 3, 0])
    got = tfs.argmax_keys(torch.from_numpy(vals), torch.from_numpy(cols))
    for i in range(len(vals)):
        want = tfs.argmax_key(vals[i], int(cols[i])) ^ (1 << 63)
        want = want - (1 << 64) if want >= (1 << 63) else want
        assert int(got[i]) == want
        assert int(tfs.keys_to_ids(got[i:i + 1])[0]) == cols[i]
    order = sorted(range(len(vals)),
                   key=lambda i: tfs.argmax_key(vals[i], int(cols[i])))
    assert order == sorted(range(len(vals)), key=lambda i: int(got[i]))
