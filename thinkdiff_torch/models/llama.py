"""Llama-family causal LM over the Qwen2 decoder stack (counterpart of
thinkdiff_tpu/models/llama.py; the reference's ``LlamaForCausalLM`` with a
per-sample ``reduction``, thinkdiff/models/modeling_llama.py:78-111, used
only by ``BaseModel.init_llm``).

Llama is Qwen2 with plain 1-D RoPE and untied embeddings, so
``llama_config`` is a ``Qwen2VLConfig`` whose M-RoPE sections are (nearly)
equal and whose three position rows are equal: standard RoPE. As in the
JAX package the q/k/v projections keep Qwen2's biases (zeros unless
loaded). The defaults are Llama-2-7B's geometry.

The decoder runs the port's kernels on the card: the flash forward (#1)
causal at head dim 128, RMSNorm (#3), and in a LoRA step the flash
backward (#5, #6).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch.func import functional_call

from thinkdiff_torch import resolve_device
from thinkdiff_torch.models.bridge import flatten, load_params, tree_of
from thinkdiff_torch.models.qwen2_vl import Qwen2VLConfig, Qwen2VLModel


def llama_config(vocab_size=32000, hidden_size=4096, intermediate_size=11008,
                 num_layers=32, num_heads=32, num_kv_heads=32,
                 rope_theta=10000.0, dtype=torch.float32,
                 **kw) -> Qwen2VLConfig:
    head_dim = hidden_size // num_heads
    third = head_dim // 6
    # sections summing to head_dim / 2: with equal t/h/w position ids this
    # is standard RoPE
    sections = (head_dim // 2 - 2 * third, third, third)
    return Qwen2VLConfig(
        vocab_size=vocab_size, hidden_size=hidden_size,
        intermediate_size=intermediate_size, num_layers=num_layers,
        num_heads=num_heads, num_kv_heads=num_kv_heads,
        rope_theta=rope_theta, mrope_section=sections,
        tie_word_embeddings=False, dtype=dtype, **kw)


class LlamaForCausalLM:
    """The model (``model``: a ``Qwen2VLModel`` on ``device``, loaded from
    the JAX-layout ``params`` when given) with the reference's ``reduction``
    semantics. ``lora_r > 0`` reproduces ``init_llm``'s peft path: rank-r
    adapters on ``lora_target_modules`` (``models/lora.py``, initial ``a``
    drawn from ``lora_generator``) are the only trainable tree
    (``trainable_params``), merged into the frozen weights inside every
    call."""

    def __init__(self, cfg: Qwen2VLConfig, params: Optional[Dict] = None, *,
                 lora_r: int = 0, lora_target_modules=("q_proj", "v_proj"),
                 lora_alpha: Optional[float] = None,
                 lora_generator: Optional[torch.Generator] = None,
                 device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = Qwen2VLModel(cfg, device=self.device)
        if params is not None:
            load_params(self.model, params)
        self.adapters = None
        self.lora_scale = 1.0
        if lora_r > 0:
            from thinkdiff_torch.models.lora import init_lora, lora_scale

            gen = lora_generator or torch.Generator(
                device=self.device).manual_seed(0)
            self.adapters = init_lora(gen, self.base_params(), lora_r,
                                      targets=tuple(lora_target_modules),
                                      alpha=lora_alpha)
            self.lora_scale = lora_scale(lora_r, lora_alpha)

    def base_params(self) -> Dict[str, Any]:
        """The frozen weights as a JAX-layout tree of the module's tensors."""
        return tree_of(self.model, lambda _, t: t)

    def trainable_params(self):
        """The adapters, or nothing (the reference freezes all of Llama when
        lora_r is 0)."""
        return self.adapters if self.adapters is not None else {}

    def __call__(self, input_ids, labels=None, reduction: str = "mean",
                 adapters=None):
        """input_ids (B, T) -> {"logits"}; with labels (B, T) (-100 is
        ignored) also {"loss"}: the next-token CE in f32, the mean over
        every valid token, or with ``reduction="none"`` each sample's
        mean."""
        adapters = adapters if adapters is not None else self.adapters
        ids = torch.as_tensor(input_ids, device=self.device).long()
        b, t = ids.shape
        pos = torch.arange(t, device=self.device)[None, None].expand(3, b, t)
        kwargs = dict(input_ids=ids, position_ids=pos)
        if adapters:
            from thinkdiff_torch.models.lora import merge_lora

            merged = merge_lora({p: w for p, w in flatten(
                self.base_params()).items() if p in adapters}, adapters,
                scale=self.lora_scale)
            logits = functional_call(
                self.model, {p.replace("/", "."): w
                             for p, w in merged.items()}, (), kwargs)[0]
        else:
            logits = self.model(**kwargs)[0]
        if labels is None:
            return {"logits": logits}
        labels = torch.as_tensor(labels, device=self.device).long()
        shift_labels = labels[:, 1:]
        valid = shift_labels != -100
        logp = F.log_softmax(logits[:, :-1].float(), dim=-1)
        tok_ll = logp.gather(-1, torch.where(valid, shift_labels, 0)[
            ..., None])[..., 0]
        tok_loss = -tok_ll * valid
        if reduction == "none":
            # each sample's mean (reference modeling_llama.py:78-81)
            loss = tok_loss.sum(-1) / valid.sum(-1).clamp_min(1)
        else:
            loss = tok_loss.sum() / valid.sum().clamp_min(1)
        return {"loss": loss, "logits": logits}
