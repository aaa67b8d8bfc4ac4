"""Port parity: thinkdiff_torch.ops.paged_attention against the JAX package
(its XLA gather oracle and its Pallas kernel in interpret mode), in f32 on
the CPU, plus the in-place pool updates. Tolerance 1e-5: the same f32
softmax over the same inputs, summed in another order."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from thinkdiff_torch.ops import paged_attention as tpa
from thinkdiff_tpu.ops import paged_attention as jpa

TOL = dict(rtol=1e-5, atol=1e-5)


def _paged_case(seed, slots, h, hkv, d, page, mp, lengths=None):
    """A random pool with non-overlapping page tables (page 0 = trash) and
    garbage in the trash page and past every slot's length."""
    rs = np.random.RandomState(seed)
    if lengths is None:
        lengths = rs.randint(1, mp * page + 1, size=slots)
    lengths = np.asarray(lengths, np.int32)
    table = np.zeros((slots, mp), np.int32)
    nxt = 1
    for s in range(slots):
        npg = -(-int(lengths[s]) // page)
        table[s, :npg] = np.arange(nxt, nxt + npg)
        nxt += npg
    pool_pages = nxt + 2  # two pages no slot owns
    k_pool = rs.randn(pool_pages, hkv, page, d).astype(np.float32)
    v_pool = rs.randn(pool_pages, hkv, page, d).astype(np.float32)
    q = rs.randn(slots, h, d).astype(np.float32)
    return q, k_pool, v_pool, table, lengths


def _poison(k_pool, v_pool, table, lengths, page):
    """Garbage where no slot may read: the trash page, pages nobody owns
    and the tail of each slot's last page."""
    kp, vp = k_pool.copy(), v_pool.copy()
    kp[0], vp[0] = 1e4, -1e4
    kp[-2:], vp[-2:] = 3e3, -3e3
    for s, length in enumerate(lengths):
        off = int(length) % page
        if off:
            last = table[s, -(-int(length) // page) - 1]
            kp[last, :, off:], vp[last, :, off:] = 777.0, -777.0
    return kp, vp


CASES = {
    # ragged lengths including 1, exactly one page and one past it
    "ragged_gqa6": dict(seed=0, slots=6, h=12, hkv=2, d=32, page=64, mp=3,
                        lengths=[1, 64, 65, 130, 7, 192]),
    "page16_d128": dict(seed=1, slots=4, h=8, hkv=2, d=128, page=16, mp=3),
    "page8_mha": dict(seed=2, slots=5, h=4, hkv=4, d=16, page=8, mp=4),
}


def _run(fn, q, kp, vp, table, lengths, torch_side):
    if torch_side:
        return fn(torch.from_numpy(q), torch.from_numpy(kp),
                  torch.from_numpy(vp), torch.from_numpy(table),
                  torch.from_numpy(lengths)).numpy()
    return np.asarray(fn(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                         jnp.asarray(table), jnp.asarray(lengths)))


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_jax_oracle_and_interpret_kernel(case):
    c = CASES[case]
    q, kp, vp, table, lens = _paged_case(**c)
    kp, vp = _poison(kp, vp, table, lens, c["page"])
    got = _run(tpa.paged_attention, q, kp, vp, table, lens, True)
    np.testing.assert_allclose(
        got, _run(jpa.paged_attention_xla, q, kp, vp, table, lens, False),
        **TOL)
    pallas = lambda *a: jpa.paged_attention_pallas(*a, interpret=True)
    np.testing.assert_allclose(
        got, _run(pallas, q, kp, vp, table, lens, False), **TOL)


def test_garbage_outside_the_live_pages_does_not_change_the_output():
    c = CASES["ragged_gqa6"]
    q, kp, vp, table, lens = _paged_case(**c)
    clean = _run(tpa.paged_attention_reference, q, kp, vp, table, lens, True)
    kp2, vp2 = _poison(kp, vp, table, lens, c["page"])
    dirty = _run(tpa.paged_attention_reference, q, kp2, vp2, table, lens, True)
    np.testing.assert_array_equal(clean, dirty)


def test_cpu_wrapper_is_the_reference_and_sm_scale_defaults():
    q, kp, vp, table, lens = _paged_case(3, 3, 4, 2, 16, 8, 2)
    args = [torch.from_numpy(a) for a in (q, kp, vp, table, lens)]
    assert torch.equal(tpa.paged_attention(*args),
                       tpa.paged_attention_reference(*args, 16 ** -0.5))
    assert not torch.equal(tpa.paged_attention(*args, sm_scale=1.0),
                           tpa.paged_attention(*args))


def test_update_kv_round_trip_matches_jax():
    rs = np.random.RandomState(3)
    slots, hkv, d, page, mp = 4, 2, 16, 8, 3
    table = (1 + np.arange(slots)[:, None] * mp + np.arange(mp)).astype(np.int32)
    lens = np.array([0, 7, 8, 23], np.int32)  # offsets 0, mid, boundary, last
    k_new = rs.randn(slots, hkv, 1, d).astype(np.float32)
    v_new = rs.randn(slots, hkv, 1, d).astype(np.float32)
    pools = [np.zeros((1 + slots * mp, hkv, page, d), np.float32)
             for _ in range(2)]
    jk, jv = jpa.paged_update_kv(jnp.asarray(pools[0]), jnp.asarray(pools[1]),
                                 jnp.asarray(k_new), jnp.asarray(v_new),
                                 jnp.asarray(table), jnp.asarray(lens))
    tk, tv = [torch.from_numpy(p.copy()) for p in pools]
    out = tpa.paged_update_kv(tk, tv, torch.from_numpy(k_new),
                              torch.from_numpy(v_new), torch.from_numpy(table),
                              torch.from_numpy(lens))
    assert out[0] is tk and out[1] is tv  # in place
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    for s in range(slots):
        pid = table[s, lens[s] // page]
        np.testing.assert_array_equal(tk[pid, :, lens[s] % page].numpy(),
                                      k_new[s, :, 0])


def test_update_kv_overflow_lands_on_the_trash_page():
    """Positions past a slot's pages land on trash page 0 (the clamped
    table entry is 0) — several slots at once, the only page that may take
    duplicate writes — and live pages stay as they were, as in JAX."""
    hkv, d, page = 2, 8, 4
    table = np.array([[1, 0], [2, 0], [3, 0]], np.int32)  # one page each
    lens = np.array([9, 4, 5], np.int32)  # all past their one page
    k_new = np.full((3, hkv, d), 5.0, np.float32)
    base = np.ones((4, hkv, page, d), np.float32)
    tk, tv = torch.from_numpy(base.copy()), torch.from_numpy(base.copy())
    tpa.paged_update_kv(tk, tv, torch.from_numpy(k_new),
                        torch.from_numpy(k_new), torch.from_numpy(table),
                        torch.from_numpy(lens))
    jk, _ = jpa.paged_update_kv(jnp.asarray(base), jnp.asarray(base),
                                jnp.asarray(k_new), jnp.asarray(k_new),
                                jnp.asarray(table), jnp.asarray(lens))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tk[1:].numpy(), base[1:])
    assert (tk[0] == 5.0).any()


def test_commit_pages_layout_matches_jax():
    rs = np.random.RandomState(4)
    m, hkv, pad, d, page = 3, 2, 16, 8, 8
    dense = rs.randn(m, hkv, pad, d).astype(np.float32)
    rows = np.array([1, 2, 3, 4, 5, 0], np.int32)  # slot 2's 2nd page: trash
    pool = np.zeros((8, hkv, page, d), np.float32)
    want = np.asarray(jpa.commit_pages(jnp.asarray(pool), jnp.asarray(dense),
                                       jnp.asarray(rows)))
    got = torch.from_numpy(pool.copy())
    tpa.commit_pages(got, torch.from_numpy(dense), torch.from_numpy(rows))
    np.testing.assert_array_equal(got[1:].numpy(), want[1:])
    np.testing.assert_array_equal(got[2].numpy(), dense[0, :, 8:])


def test_model_paged_decode_matches_dense_decode():
    """The decoder with page_table == the decoder over a dense cache: the
    same prompt committed to pages, then three decode steps each way."""
    from thinkdiff_torch.models.bridge import load_params
    from thinkdiff_torch.models.qwen2_vl import (
        Qwen2VLConfig, Qwen2VLModel, init_params)

    cfg = Qwen2VLConfig.tiny()
    g = torch.Generator().manual_seed(0)
    lm = load_params(Qwen2VLModel(cfg), init_params(cfg, g, std=0.2)["lm"])
    b, t, page, steps = 2, 11, 8, 3
    ids = torch.randint(1, 200, (b, t), generator=g)
    pos = torch.arange(t)[None, None].expand(3, b, t)
    lens = torch.tensor([11, 6])
    mask = (torch.arange(t)[None] < lens[:, None]).long()
    hd, hkv = cfg.head_dim, cfg.num_kv_heads
    dense = [(torch.zeros(b, hkv, 16 + steps, hd), torch.zeros(b, hkv, 16 + steps, hd))
             for _ in range(cfg.num_layers)]
    with torch.no_grad():
        lm(input_ids=ids, position_ids=pos, mask=mask, caches=dense,
           compute_logits=False)
        table = torch.tensor([[1, 2, 3], [4, 5, 6]], dtype=torch.int32)
        pools = [(torch.zeros(7, hkv, page, hd), torch.zeros(7, hkv, page, hd))
                 for _ in range(cfg.num_layers)]
        rows = torch.tensor([1, 2, 4, 0])  # slot 1 holds one prompt page
        for (kp, vp), (kd, vd) in zip(pools, dense):
            tpa.commit_pages(kp, kd[:, :, :16], rows)
            tpa.commit_pages(vp, vd[:, :, :16], rows)
        tok = torch.tensor([5, 7])
        cl = lens.clone()
        for _ in range(steps):
            p3 = cl[None, :, None].expand(3, b, 1)
            _, hd_dense, _ = lm(input_ids=tok[:, None], position_ids=p3,
                                caches=dense, cache_len=cl,
                                compute_logits=False)
            _, hd_paged, _ = lm(input_ids=tok[:, None], position_ids=p3,
                                caches=pools, cache_len=cl, page_table=table,
                                compute_logits=False)
            np.testing.assert_allclose(hd_paged.numpy(), hd_dense.numpy(),
                                       **TOL)
            tok, cl = tok + 1, cl + 1


# the kernel's plan: (slots, kv heads, MP, page) of the serving slices (2B at
# 256 and 64 slots, 7B's 4 kv heads), long-context skews, small batches
# and the smaller pages; an H100's 132 SMs, an H100 PCIe's 114, 78
PLAN_SHAPES = [(256, 2, 10, 64), (64, 2, 10, 64), (64, 2, 32, 64),
               (16, 4, 10, 64), (8, 4, 40, 64), (6, 2, 10, 64),
               (4, 2, 7, 16), (3, 4, 3, 32), (1, 2, 1, 64), (512, 2, 5, 16)]


@pytest.mark.parametrize("sms", [132, 114, 78])
@pytest.mark.parametrize("s,hkv,mp,page", PLAN_SHAPES)
def test_paged_plan_covers_every_page_once(s, hkv, mp, page, sms):
    """A slot's MP pages fall in exactly one unit each, no unit is empty, a
    unit is a whole number of 64-token stages, and the units of every
    (slot, kv head) hold the same pages to within one unit (only the last
    is shorter). A unit holds at most PAGED_UNIT_STAGES stages; where the
    pairs so cut fill half the SMs there is no further split, and where
    they do not, the split fills the SMs."""
    ppu = tpa.paged_plan(s, hkv, mp, page, sms)
    pps = tpa.PAGED_TOKENS // page
    assert ppu % pps == 0
    splits = -(-mp // ppu)
    covered = np.zeros(mp, np.int64)
    for sp in range(splits):
        lo, hi = sp * ppu, min(mp, (sp + 1) * ppu)
        assert lo < hi
        covered[lo:hi] += 1
    assert (covered == 1).all()
    total = -(-mp // pps)  # stages of MP pages
    assert ppu // pps <= tpa.PAGED_UNIT_STAGES
    capped = -(-total // tpa.PAGED_UNIT_STAGES)
    if s * hkv * capped >= sms // 2:
        assert splits == capped
    else:
        assert s * hkv * splits >= min(sms, s * hkv * total)


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_launch_plan_reads_no_lengths():
    """The wrapper plans its launch from shapes alone: on tensors without
    data (the meta device) it still returns the plan, so it reads nothing
    back from the card (no sync; a CUDA graph can capture the launch)."""
    args = (_meta(256, 12, 128), _meta(3000, 2, 64, 128),
            _meta(3000, 2, 64, 128), _meta(256, 10, dtype=torch.int32))
    for dtype in (torch.int32, torch.int64):
        assert tpa._paged_args(*args, _meta(256, dtype=dtype), 132) == (10, 1)
    assert tpa._paged_args(_meta(64, 28, 128), _meta(900, 4, 64, 128),
                           _meta(900, 4, 64, 128),
                           _meta(64, 10, dtype=torch.int32),
                           _meta(64, dtype=torch.int64), 132) == (10, 1)


@pytest.mark.parametrize("bad,match", [
    (dict(page=8), "pages of"), (dict(d=64), "D=128"),
    (dict(h=36), "query heads"), (dict(lens=torch.float32), "lengths"),
    (dict(pool=torch.float32), "bf16"), (dict(table_rows=3), "bad shapes")])
def test_launch_plan_refuses_what_the_kernel_cannot_take(bad, match):
    page, d, h = bad.get("page", 64), bad.get("d", 128), bad.get("h", 12)
    pool = _meta(100, 2, page, d, dtype=bad.get("pool", torch.bfloat16))
    with pytest.raises((ValueError, TypeError), match=match):
        tpa._paged_args(_meta(4, h, d), pool, pool,
                        _meta(bad.get("table_rows", 4), 3, dtype=torch.int32),
                        _meta(4, dtype=bad.get("lens", torch.int32)), 132)
