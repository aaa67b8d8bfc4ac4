"""Port parity: Llama over the Qwen2 stack (``thinkdiff_torch/models/
llama.py``) and its LoRA adapters (``models/lora.py``) against the JAX
package at tiny geometry on the CPU (the kernels' plain versions), on the
same bridged weights, with JAX's adapter arrays carried across: the
logits and both reductions (f32: within 1e-5 of the largest logit, losses
1e-5 relative), identity at init, "only the targets change", gradients
reaching the adapters only and equal to JAX's (within 1e-4 of the
largest), and the errors where there is no target."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thinkdiff_torch.models import llama as tl
from thinkdiff_torch.models import lora as tlo
from thinkdiff_torch.models.bridge import flatten, to_tensor
from thinkdiff_tpu.models import llama as jl
from thinkdiff_tpu.models import lora as jlo
from thinkdiff_tpu.models.qwen2_vl import Qwen2VLModel as JModel
from tests.test_torch_flux import randomize

GEOM = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
            num_layers=2, num_heads=4, num_kv_heads=2)
LOGIT_TOL = 1e-5
GRAD_TOL = 1e-4


@pytest.fixture(scope="module")
def tiny():
    """The JAX config, its initialized tree with every leaf redrawn (so
    that the q/k/v biases and norm scales matter), and the port's config."""
    cfg = jl.llama_config(**GEOM)
    params = JModel(cfg).init(
        jax.random.PRNGKey(0), input_ids=jnp.zeros((1, 4), jnp.int32),
        position_ids=jnp.zeros((3, 1, 4), jnp.int32))["params"]
    params = randomize(jax.tree.map(np.asarray, params),
                       np.random.RandomState(0))
    return cfg, params, tl.llama_config(**GEOM)


def _ids_labels(seed=0):
    rs = np.random.RandomState(seed)
    ids = rs.randint(1, 64, (3, 7)).astype(np.int32)
    labels = rs.randint(1, 64, (3, 7)).astype(np.int32)
    labels[1, 4:] = -100
    labels[2, 1:] = -100  # no valid target: its per-sample loss is 0
    return ids, labels


def _planted(jax_adapters, seed=2):
    """JAX's adapters with ``b`` redrawn, so that the deltas show."""
    rs = np.random.RandomState(seed)
    return {k: {"a": np.asarray(v["a"]),
                "b": (0.1 * rs.randn(*v["b"].shape)).astype(np.float32)}
            for k, v in jax_adapters.items()}


def test_config_is_jax_s(tiny):
    jcfg, _, tcfg = tiny
    for f in ("vocab_size", "hidden_size", "intermediate_size", "num_layers",
              "num_heads", "num_kv_heads", "rope_theta",
              "tie_word_embeddings"):
        assert getattr(tcfg, f) == getattr(jcfg, f), f
    assert tuple(tcfg.mrope_section) == tuple(jcfg.mrope_section)
    seven_b = tl.llama_config()
    assert (seven_b.hidden_size, seven_b.intermediate_size,
            seven_b.num_layers, seven_b.vocab_size,
            tuple(seven_b.mrope_section)) == (4096, 11008, 32, 32000,
                                              (22, 21, 21))


@pytest.mark.parametrize("reduction", ["mean", "none"])
def test_logits_and_loss_match_jax(tiny, reduction):
    jcfg, params, tcfg = tiny
    ids, labels = _ids_labels()
    want = jl.LlamaForCausalLM(jcfg, params)(
        jnp.asarray(ids), labels=jnp.asarray(labels), reduction=reduction)
    port = tl.LlamaForCausalLM(tcfg, params, device="cpu")
    with torch.no_grad():
        got = port(ids, labels=labels, reduction=reduction)
    wl = np.asarray(want["logits"])
    np.testing.assert_allclose(got["logits"].numpy(), wl, rtol=0,
                               atol=LOGIT_TOL * np.abs(wl).max())
    np.testing.assert_allclose(got["loss"].numpy(), np.asarray(want["loss"]),
                               rtol=1e-5, atol=1e-7)
    assert got["loss"].shape == ((3,) if reduction == "none" else ())
    if reduction == "none":
        assert float(got["loss"][2]) == 0.0
    assert "loss" not in port(ids)


def test_lora_is_the_base_model_at_init(tiny):
    _, params, tcfg = tiny
    ids, _ = _ids_labels(1)
    base = tl.LlamaForCausalLM(tcfg, params, device="cpu")
    lora = tl.LlamaForCausalLM(tcfg, params, lora_r=4, device="cpu",
                               lora_generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        assert torch.equal(base(ids)["logits"], lora(ids)["logits"])
    ad = lora.trainable_params()
    assert len(ad) == 2 * tcfg.num_layers
    for key, leaf in ad.items():
        assert key.endswith(("q_proj/kernel", "v_proj/kernel")), key
        d_in = leaf["a"].shape[0]
        assert leaf["a"].shape[1] == 4 and leaf["b"].shape[0] == 4
        assert float(leaf["b"].abs().max()) == 0.0
        assert 0 < float(leaf["a"].abs().max()) <= d_in ** -0.5
    jad = jlo.init_lora(jax.random.PRNGKey(1), params, r=4)
    assert sorted(ad) == sorted(jad)
    assert tlo.lora_param_count(ad) == jlo.lora_param_count(jad)
    assert base.trainable_params() == {}


def test_merge_changes_only_the_targets_as_jax_does(tiny):
    _, params, _ = tiny
    ad = _planted(jlo.init_lora(jax.random.PRNGKey(1), params, r=4))
    for scale in (1.0, tlo.lora_scale(4, 16)):
        got = flatten(tlo.merge_lora(params, ad, scale=scale))
        want = flatten(jax.tree.map(np.asarray, jlo.merge_lora(
            params, ad, scale=scale)))
        base = flatten(params)
        assert sorted(got) == sorted(want)
        changed = 0
        for k, w in want.items():
            g = np.asarray(got[k])
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7, err_msg=k)
            if k in ad:
                changed += 1
                assert not np.array_equal(g, base[k]), k
            else:
                assert got[k] is base[k], k
        assert changed == len(ad)
    # bf16 weights: the delta in f32, the sum cast back to W's dtype
    k = next(iter(ad))
    w16 = to_tensor(base_w := flatten(params)[k]).bfloat16()
    m = tlo.merge_lora({"w": w16}, {"w": ad[k]})["w"]
    want = (w16.float() + torch.from_numpy(ad[k]["a"] @ ad[k]["b"])).bfloat16()
    assert m.dtype == torch.bfloat16 and torch.equal(m, want)
    assert base_w.shape == m.shape


def test_lora_forward_and_gradients_match_jax(tiny):
    """JAX's adapters (b planted) carried across: the loss, and gradients
    that reach the adapters only, equal to jax.grad's."""
    jcfg, params, tcfg = tiny
    ids, labels = _ids_labels(2)
    jad = jax.tree.map(jnp.asarray, _planted(
        jlo.init_lora(jax.random.PRNGKey(1), params, r=4)))
    jm = jl.LlamaForCausalLM(jcfg, params, lora_r=4, lora_alpha=8.0)
    jloss, jgrad = jax.value_and_grad(lambda a: jm(
        jnp.asarray(ids), labels=jnp.asarray(labels), adapters=a)["loss"])(jad)
    port = tl.LlamaForCausalLM(tcfg, params, lora_r=4, lora_alpha=8.0,
                               device="cpu")
    ad = {k: {n: torch.tensor(np.asarray(v), requires_grad=True)
              for n, v in layer.items()} for k, layer in jad.items()}
    loss = port(ids, labels=labels, adapters=ad)["loss"]
    loss.backward()
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    for k, layer in jgrad.items():
        for n, want in layer.items():
            want = np.asarray(want)
            np.testing.assert_allclose(
                ad[k][n].grad.numpy(), want, rtol=0,
                atol=GRAD_TOL * np.abs(want).max(), err_msg=f"{k}/{n}")
    assert all(p.grad is None and not p.requires_grad
               for p in port.model.parameters())


def test_adapter_gradients_at_init_and_a_step_lowers_nothing_else(tiny):
    """At init b = 0: a's gradient is 0 and b's is not (standard LoRA); an
    AdamW step on the adapters changes the loss and leaves the base."""
    _, params, tcfg = tiny
    ids, labels = _ids_labels(3)
    port = tl.LlamaForCausalLM(tcfg, params, lora_r=4, device="cpu")
    leaves = [t.requires_grad_(True) for layer in port.adapters.values()
              for t in layer.values()]
    before = {k: v.clone() for k, v in port.model.state_dict().items()}
    loss0 = port(ids, labels=labels)["loss"]
    loss0.backward()
    for layer in port.adapters.values():
        assert float(layer["a"].grad.abs().max()) == 0.0
        assert float(layer["b"].grad.abs().max()) > 0.0
    opt = torch.optim.AdamW(leaves, lr=1e-2)
    opt.step()
    with torch.no_grad():
        loss1 = port(ids, labels=labels)["loss"]
    assert float(loss1) != float(loss0)
    for k, v in port.model.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_no_target_raises_as_jax(tiny):
    """Fused q/k/v (``fused_proj``) leaves no q_proj / v_proj kernel."""
    jcfg, params, tcfg = tiny
    import dataclasses

    from thinkdiff_torch.models.qwen2_vl import fuse_qwen2_params

    fused = fuse_qwen2_params(params)
    with pytest.raises(ValueError, match="no LoRA targets"):
        jlo.init_lora(jax.random.PRNGKey(0), fused, r=4)
    with pytest.raises(ValueError, match="no LoRA targets"):
        tl.LlamaForCausalLM(dataclasses.replace(tcfg, fused_proj=True),
                            fused, lora_r=4, device="cpu")
    for r, alpha in ((4, None), (8, 16.0), (16, 8)):
        assert tlo.lora_scale(r, alpha) == jlo.lora_scale(r, alpha)
