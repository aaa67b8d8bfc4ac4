"""The flan-t5 decoder side (counterpart of thinkdiff_tpu/models/t5.py).

What the LVLM aligner runs: the shared embedding, the encoder-less decoder
(causal self-attention with the relative-position bias, cross-attention to
any (B, S, D) states), the final norm and the untied lm_head, all frozen.
The encoder (ThinkDiff-CLIP's) is not ported yet.

T5 quirks kept for parity: NO 1/sqrt(d) attention scaling (``sm_scale``
1.0), one relative-position bias computed per forward and shared by every
layer, RMS norms, gated-gelu FFN with the tanh gelu, untied lm_head.

Parameter names and layouts are the JAX ones (``decoder.block_0.self_attn
.qkv.kernel_q``, ...), so ``models/bridge.py`` loads a JAX tree key for
key. Every weight is frozen (requires_grad False); gradients flow to the
inputs only. The modules are deterministic: the aligner runs T5 with
dropout off (``deterministic=True`` on every JAX call of this path).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from thinkdiff_torch.models.qdense import QDense, concat_dense_params
from thinkdiff_torch.ops.flash_attention import flash_attention, kernel_bias
from thinkdiff_torch.ops.norms import rmsnorm


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 4096
    d_kv: int = 64
    d_ff: int = 10240
    num_layers: int = 24
    num_decoder_layers: int = 24
    num_heads: int = 64
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6
    feed_forward_proj: str = "gated-gelu"  # flan-t5; "relu" for t5v1.0
    tie_word_embeddings: bool = False
    dropout_rate: float = 0.1
    # self-attn q|k|v -> 'qkv', cross-attn k|v -> 'kv_fused', gated FFN
    # wi_0|wi_1 -> 'wi_fused' (fuse_t5_params converts a tree)
    fused_proj: bool = False
    # False | True/"int8" (weight-only) | "w8a8" — see QDense
    quant_int8: Any = False
    dtype: Any = torch.float32

    @property
    def is_gated(self) -> bool:
        return self.feed_forward_proj.startswith("gated-")

    def act_fn(self, x: torch.Tensor) -> torch.Tensor:
        act = self.feed_forward_proj.replace("gated-", "")
        if act == "gelu":  # HF's gelu_new: the tanh approximation
            return F.gelu(x, approximate="tanh")
        if act == "relu":
            return F.relu(x)
        if act == "silu":
            return F.silu(x)
        raise ValueError(act)

    @classmethod
    def tiny(cls, **kw):
        base = dict(vocab_size=128, d_model=32, d_kv=8, d_ff=64, num_layers=2,
                    num_decoder_layers=2, num_heads=4, dropout_rate=0.0)
        base.update(kw)
        return cls(**base)

    @classmethod
    def flan_t5_xxl(cls, **kw):
        return cls(**{**dict(dtype=torch.bfloat16), **kw})


def relative_position_bucket(relative_position: torch.Tensor,
                             bidirectional: bool, num_buckets: int,
                             max_distance: int) -> torch.Tensor:
    """HF T5 bucket function, in JAX's arithmetic: the float32 log of
    n / max_exact + 1e-6, truncated toward zero."""
    n = relative_position.to(torch.int32)
    ret = torch.zeros_like(n)
    if bidirectional:
        num_buckets //= 2
        ret = ret + (n > 0).to(torch.int32) * num_buckets
        n = n.abs()
    else:
        n = -torch.clamp(n, max=0)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    val_if_large = max_exact + (
        torch.log(n.to(torch.float32) / max_exact + 1e-6)
        / math.log(max_distance / max_exact)
        * (num_buckets - max_exact)).to(torch.int32)
    val_if_large = torch.clamp(val_if_large, max=num_buckets - 1)
    return ret + torch.where(is_small, n, val_if_large)


def _frozen(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


class T5LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.weight = _frozen((dim,), torch.float32, device)
        with torch.no_grad():
            self.weight.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rmsnorm(x.to(self.dtype), self.weight.to(self.dtype), self.eps)


def _dense(cfg: T5Config, in_dim: int, features: int, device):
    # the tower's only job in the port is the aligner's training step, so a
    # w8a8 layer keeps the (K, N) weight copy its input gradient reads
    return QDense(in_dim, features, dtype=cfg.dtype, quant=cfg.quant_int8,
                  device=device, train_layout=True)


class T5Attention(nn.Module):
    def __init__(self, cfg: T5Config, causal: bool, cross: bool, device=None):
        super().__init__()
        self.cfg, self.causal = cfg, causal
        inner = cfg.num_heads * cfg.d_kv
        dense = lambda features: _dense(cfg, cfg.d_model, features, device)
        if cfg.fused_proj and not cross:
            self.qkv = dense(3 * inner)
        elif cfg.fused_proj:
            self.q = dense(inner)
            self.kv_fused = dense(2 * inner)
        else:
            self.q, self.k, self.v = dense(inner), dense(inner), dense(inner)
        self.o = _dense(cfg, inner, cfg.d_model, device)

    def forward(self, hidden, kv=None, position_bias=None, mask=None,
                q_segments=None, kv_segments=None):
        """hidden (B, Tq, D); kv the cross-attention source (B, Tk, D) or
        None; mask (B, Tk) 1/0 key validity; position_bias additive
        (1|B, H, Tq, Tk); q/kv_segments (B, Tq)/(B, Tk) packing ids (>= 1
        real, 0 pad), same-segment attention only. Returns (B, Tq, D)."""
        cfg = self.cfg
        inner = cfg.num_heads * cfg.d_kv
        if cfg.fused_proj and kv is None:
            q, k, v = self.qkv(hidden).split(inner, dim=-1)
        elif cfg.fused_proj:
            q = self.q(hidden)
            k, v = self.kv_fused(kv).split(inner, dim=-1)
        else:
            source = hidden if kv is None else kv
            q, k, v = self.q(hidden), self.k(source), self.v(source)
        b, tq, _ = q.shape
        tk = k.shape[1]
        heads = lambda x, t: x.reshape(b, t, cfg.num_heads, cfg.d_kv).transpose(1, 2)
        q, k, v = heads(q, tq), heads(k, tk), heads(v, tk)
        bias = None if position_bias is None else position_bias.float()
        kv_mask = None if mask is None else mask.to(torch.int32)
        if q_segments is None or kv_segments is None:
            q_segments = kv_segments = None  # ids only act in pairs
        # T5 has no 1/sqrt(d) scaling
        out = flash_attention(q, k, v, bias, kv_mask, self.causal, 1.0,
                              q_segments, kv_segments)
        return self.o(out.transpose(1, 2).reshape(b, tq, inner))


class T5RelativeBias(nn.Module):
    def __init__(self, cfg: T5Config, bidirectional: bool, device=None):
        super().__init__()
        self.cfg, self.bidirectional = cfg, bidirectional
        self.rel_embedding = _frozen(
            (cfg.relative_attention_num_buckets, cfg.num_heads), cfg.dtype,
            device)

    def forward(self, q_len: int, k_len: int) -> torch.Tensor:
        """(1, H, Tq, Tk) in the model dtype."""
        dev = self.rel_embedding.device
        ctx = torch.arange(q_len, device=dev)[:, None]
        mem = torch.arange(k_len, device=dev)[None, :]
        buckets = relative_position_bucket(
            mem - ctx, self.bidirectional,
            self.cfg.relative_attention_num_buckets,
            self.cfg.relative_attention_max_distance)
        return self.rel_embedding[buckets.long()].permute(2, 0, 1)[None]


class T5FFN(nn.Module):
    def __init__(self, cfg: T5Config, device=None):
        super().__init__()
        self.cfg = cfg
        dense = lambda i, o: _dense(cfg, i, o, device)
        if cfg.is_gated and cfg.fused_proj:
            self.wi_fused = dense(cfg.d_model, 2 * cfg.d_ff)
        elif cfg.is_gated:
            self.wi_0 = dense(cfg.d_model, cfg.d_ff)
            self.wi_1 = dense(cfg.d_model, cfg.d_ff)
        else:
            self.wi = dense(cfg.d_model, cfg.d_ff)
        self.wo = dense(cfg.d_ff, cfg.d_model)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        if cfg.is_gated and cfg.fused_proj:
            gate, up = self.wi_fused(x).split(cfg.d_ff, dim=-1)
            h = cfg.act_fn(gate) * up
        elif cfg.is_gated:
            h = cfg.act_fn(self.wi_0(x)) * self.wi_1(x)
        else:
            h = cfg.act_fn(self.wi(x))
        return self.wo(h)


class T5Block(nn.Module):
    def __init__(self, cfg: T5Config, causal: bool, has_cross: bool,
                 device=None):
        super().__init__()
        self.has_cross = has_cross
        norm = lambda: T5LayerNorm(cfg.d_model, cfg.layer_norm_epsilon,
                                   cfg.dtype, device)
        self.self_attn_norm = norm()
        self.self_attn = T5Attention(cfg, causal, False, device)
        if has_cross:
            self.cross_attn_norm = norm()
            self.cross_attn = T5Attention(cfg, False, True, device)
        self.ffn_norm = norm()
        self.ffn = T5FFN(cfg, device)

    def forward(self, x, encoder_states=None, self_bias=None, self_mask=None,
                cross_mask=None, segments=None, enc_segments=None):
        h = self.self_attn(self.self_attn_norm(x), position_bias=self_bias,
                           mask=self_mask, q_segments=segments,
                           kv_segments=segments)
        x = x + h
        if self.has_cross:
            h = self.cross_attn(self.cross_attn_norm(x), kv=encoder_states,
                                mask=cross_mask, q_segments=segments,
                                kv_segments=enc_segments)
            x = x + h
        return x + self.ffn(self.ffn_norm(x))


class T5Decoder(nn.Module):
    def __init__(self, cfg: T5Config, device=None):
        super().__init__()
        self.cfg = cfg
        self.rel_bias = T5RelativeBias(cfg, bidirectional=False, device=device)
        for i in range(cfg.num_decoder_layers):
            setattr(self, f"block_{i}", T5Block(cfg, True, True, device))
        self.final_norm = T5LayerNorm(cfg.d_model, cfg.layer_norm_epsilon,
                                      cfg.dtype, device)

    def forward(self, input_embeds, encoder_states, self_mask=None,
                cross_mask=None, segments=None, enc_segments=None):
        t = input_embeds.shape[1]
        # f32, rows 16 bytes apart: the forward kernel's layout, made once
        # for every layer
        bias = kernel_bias(self.rel_bias(t, t))
        x = input_embeds
        for i in range(self.cfg.num_decoder_layers):
            x = getattr(self, f"block_{i}")(
                x, encoder_states, bias, self_mask, cross_mask, segments,
                enc_segments)
        return self.final_norm(x)


class T5ForConditionalGeneration(nn.Module):
    """The encoder-less decoder stack of the aligner: ``shared``,
    ``decoder`` and (untied) ``lm_head``. Its w8a8 layers keep the weight
    copy their input gradient reads (``QDense`` ``train_layout``)."""

    def __init__(self, cfg: T5Config, device=None):
        super().__init__()
        self.cfg = cfg
        self.shared = nn.Module()
        self.shared.embedding = _frozen((cfg.vocab_size, cfg.d_model),
                                        cfg.dtype, device)
        self.decoder = T5Decoder(cfg, device)
        if not cfg.tie_word_embeddings:
            self.lm_head = _dense(cfg, cfg.d_model, cfg.vocab_size, device)

    def decode_hidden(self, decoder_input_ids, encoder_states,
                      cross_mask=None, decoder_mask=None,
                      decoder_segments=None, encoder_segments=None):
        """Decoder final hidden states (B, T, D), the pre-lm_head tap.
        decoder/encoder_segments enable packed rows (cross-attention
        restricted to the matching encoder segment)."""
        dec_embeds = F.embedding(decoder_input_ids.long(), self.shared.embedding)
        return self.decoder(dec_embeds, encoder_states.to(dec_embeds.dtype),
                            self_mask=decoder_mask, cross_mask=cross_mask,
                            segments=decoder_segments,
                            enc_segments=encoder_segments)

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        if self.cfg.tie_word_embeddings:
            hidden = hidden * (self.cfg.d_model ** -0.5)
            return hidden @ self.shared.embedding.t()
        return self.lm_head(hidden)

    def decode_with_encoder_states(self, decoder_input_ids, encoder_states,
                                   cross_mask=None, decoder_mask=None,
                                   decoder_segments=None,
                                   encoder_segments=None):
        """Encoder-less path: any (B, S, D) states condition the decoder."""
        return self.logits(self.decode_hidden(
            decoder_input_ids, encoder_states, cross_mask, decoder_mask,
            decoder_segments, encoder_segments))


def fuse_t5_params(params):
    """Unfused T5 param tree -> the ``fused_proj=True`` layout: self_attn
    {q,k,v} -> qkv, cross_attn {k,v} -> kv_fused, gated FFN {wi_0,wi_1} ->
    wi_fused. Works on fp kernels and quantized triplets."""
    groups = {"self_attn": ("qkv", ("q", "k", "v")),
              "cross_attn": ("kv_fused", ("k", "v")),
              "ffn": ("wi_fused", ("wi_0", "wi_1"))}

    def rec(node, name=""):
        if not isinstance(node, dict):
            return node
        fused, parts = groups.get(name, (None, ()))
        if parts and set(parts) <= set(node):
            out = {fused: concat_dense_params([node[p] for p in parts])}
            out.update({k: rec(v, k) for k, v in node.items() if k not in parts})
            return out
        return {k: rec(v, k) for k, v in node.items()}

    return rec(params)


def shift_right(labels: torch.Tensor, decoder_start_token_id: int = 0,
                pad_id: int = 0) -> torch.Tensor:
    """HF _shift_right: decoder inputs = labels shifted right, -100 -> pad."""
    shifted = torch.cat([torch.full_like(labels[:, :1], decoder_start_token_id),
                         labels[:, :-1]], dim=1)
    return torch.where(shifted == -100, torch.full_like(shifted, pad_id),
                       shifted)


def _token_ll(logits, labels, ignore_index):
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = logp.gather(-1, safe[..., None])[..., 0]
    return logp, ll, valid, safe


def cross_entropy_loss(logits, labels, ignore_index: int = -100):
    """Token-mean CE matching torch F.cross_entropy(ignore_index=-100)."""
    _, ll, valid, _ = _token_ll(logits, labels, ignore_index)
    return -(ll * valid).sum() / valid.sum().clamp(min=1)


def ce_stats(logits, labels, ignore_index: int = -100):
    """(loss, n_correct, n_tokens): CE plus teacher-forced next-token
    accuracy counts over non-ignored positions."""
    logp, ll, valid, safe = _token_ll(logits, labels, ignore_index)
    count = valid.float().sum()
    loss = -(ll * valid).sum() / count.clamp(min=1.0)
    hit = (logp.argmax(-1) == safe) & valid
    return loss, hit.float().sum(), count
