"""flan-t5 (counterpart of thinkdiff_tpu/models/t5.py).

What the aligners run, all frozen: the shared embedding; the encoder
(bidirectional self-attention with its relative-position bias and key
mask), which ThinkDiff-CLIP runs on the first caption half and which FLUX's
T5 text embedder is; the decoder (causal self-attention with the relative
bias, cross-attention to any (B, S, D) states), its final norm and the
untied lm_head. ``encode`` puts extra states (projected image tokens)
BEFORE the text's encoder states, their mask ones unless given. The LVLM
aligner builds no encoder (the JAX model deletes it); the T5 text embedder
builds no decoder.

T5 quirks kept for parity: NO 1/sqrt(d) attention scaling (``sm_scale``
1.0), one relative-position bias computed per forward and shared by every
layer, RMS norms, gated-gelu FFN with the tanh gelu, untied lm_head.

Parameter names and layouts are the JAX ones (``decoder.block_0.self_attn
.qkv.kernel_q``, ...), so ``models/bridge.py`` loads a JAX tree key for
key. Every weight is frozen (requires_grad False); gradients flow to the
inputs only.

On a sharded mesh (parallel/sharding.py, JAX's rules) the layers hold
their rank's blocks. Where the q/k/v projections are split over ``model``
in whole heads, an attention runs the rank's heads (a projection the rules
leave whole, the fused layout's cross-attention ``q``, computes only their
columns) and gathers their outputs before ``o``; elsewhere every rank runs
every head. The FFN's input projections split their columns and ``wo``
its rows, summed over the group. The vocabulary-split ``shared``
embedding gives zeros for an id outside the rank's rows, summed over the
group; the relative bias is replicated. The modules are deterministic: the aligner runs T5 with
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
from thinkdiff_torch.parallel import collectives as col


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
        for m in self.children():
            m.tp_unit = cfg.d_kv  # a column share keeps whole heads
        self.o = _dense(cfg, inner, cfg.d_model, device)

    def _local_heads(self, cross: bool) -> bool:
        """Whether this rank runs its heads only: the projections that
        make k and v are split over ``model`` in whole heads."""
        layer = (self.kv_fused if self.cfg.fused_proj and cross else
                 self.qkv if self.cfg.fused_proj else self.k)
        return layer.tp_local and col.model_size() > 1

    def forward(self, hidden, kv=None, position_bias=None, mask=None,
                q_segments=None, kv_segments=None):
        """hidden (B, Tq, D); kv the cross-attention source (B, Tk, D) or
        None; mask (B, Tk) 1/0 key validity; position_bias additive
        (1|B, H, Tq, Tk); q/kv_segments (B, Tq)/(B, Tk) packing ids (>= 1
        real, 0 pad), same-segment attention only. Returns (B, Tq, D)."""
        cfg = self.cfg
        local = self._local_heads(kv is not None)
        n_heads = cfg.num_heads // (col.model_size() if local else 1)
        inner = n_heads * cfg.d_kv
        if cfg.fused_proj and kv is None:
            q, k, v = self.qkv(hidden, keep_local=True).split(inner, dim=-1)
        elif cfg.fused_proj:
            q = self.q(hidden, cols=(col.model_index() * inner, inner)
                       if local else None)
            k, v = self.kv_fused(kv, keep_local=True).split(inner, dim=-1)
        else:
            source = hidden if kv is None else kv
            q, k, v = self.q(hidden), self.k(source), self.v(source)
        b, tq, _ = q.shape
        tk = k.shape[1]
        heads = lambda x, t: x.reshape(b, t, n_heads, cfg.d_kv).transpose(1, 2)
        q, k, v = heads(q, tq), heads(k, tk), heads(v, tk)
        bias = None if position_bias is None else position_bias.float()
        if bias is not None and local:
            bias = bias.narrow(1, col.model_index() * n_heads, n_heads)
        kv_mask = None if mask is None else mask.to(torch.int32)
        if q_segments is None or kv_segments is None:
            q_segments = kv_segments = None  # ids only act in pairs
        # T5 has no 1/sqrt(d) scaling
        out = flash_attention(q, k, v, bias, kv_mask, self.causal, 1.0,
                              q_segments, kv_segments)
        out = out.transpose(1, 2).reshape(b, tq, inner)
        if local:
            out = col.gather_from_model(out, -1)
        return self.o(out)


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
        """On a sharded mesh the input projections keep the rank's columns
        where ``wo`` takes the matching rows (else they are gathered, and
        a row-split ``wo`` takes its rows of the whole)."""
        cfg = self.cfg
        first = (self.wi_fused if cfg.is_gated and cfg.fused_proj else
                 self.wi_0 if cfg.is_gated else self.wi)
        local = first.tp_local and self.wo.tp_role == "row"
        if cfg.is_gated and cfg.fused_proj:
            gate, up = self.wi_fused(x, keep_local=local).chunk(2, dim=-1)
            h = cfg.act_fn(gate) * up
        elif cfg.is_gated:
            h = (cfg.act_fn(self.wi_0(x, keep_local=local))
                 * self.wi_1(x, keep_local=local))
        else:
            h = cfg.act_fn(self.wi(x, keep_local=local))
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


class T5Encoder(nn.Module):
    def __init__(self, cfg: T5Config, device=None):
        super().__init__()
        self.cfg = cfg
        self.rel_bias = T5RelativeBias(cfg, bidirectional=True, device=device)
        for i in range(cfg.num_layers):
            setattr(self, f"block_{i}", T5Block(cfg, False, False, device))
        self.final_norm = T5LayerNorm(cfg.d_model, cfg.layer_norm_epsilon,
                                      cfg.dtype, device)

    def forward(self, input_embeds, mask=None, segments=None):
        """input_embeds (B, T, D); mask (B, T) 1/0 key validity (the
        kernel's kv_mask, never a broadcast bias)."""
        t = input_embeds.shape[1]
        bias = kernel_bias(self.rel_bias(t, t))
        x = input_embeds
        for i in range(self.cfg.num_layers):
            x = getattr(self, f"block_{i}")(x, None, bias, mask, None,
                                            segments)
        return self.final_norm(x)


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
    """``shared``, the ``encoder`` when ``encoder`` is set, and the
    ``decoder`` with its (untied) ``lm_head`` when ``decoder`` is set: the
    LVLM aligner's stack is decoder-only, ThinkDiff-CLIP's has both, FLUX's
    T5 text embedder only the encoder. Its w8a8 layers keep the weight copy
    their input gradient reads (``QDense`` ``train_layout``)."""

    def __init__(self, cfg: T5Config, device=None, encoder: bool = False,
                 decoder: bool = True):
        super().__init__()
        self.cfg = cfg
        self.shared = nn.Module()
        self.shared.embedding = _frozen((cfg.vocab_size, cfg.d_model),
                                        cfg.dtype, device)
        if encoder:
            self.encoder = T5Encoder(cfg, device)
        if decoder:
            self.decoder = T5Decoder(cfg, device)
            if not cfg.tie_word_embeddings:
                self.lm_head = _dense(cfg, cfg.d_model, cfg.vocab_size, device)

    def encode(self, input_ids=None, attention_mask=None, input_embeds=None,
               extra_encoder_states=None, extra_attention_mask=None):
        """(encoder states, their mask): the encoder over the text, with
        ``extra_encoder_states`` (B, S, D) and their mask (ones unless
        given) placed BEFORE the text's states."""
        if input_embeds is None:
            input_embeds = self.embed(input_ids)
        mask = attention_mask
        if mask is not None:
            mask = mask.to(torch.int32)
        states = self.encoder(input_embeds, mask=mask)
        if mask is None:
            mask = torch.ones(states.shape[:2], dtype=torch.int32,
                              device=states.device)
        if extra_encoder_states is not None:
            extra = extra_encoder_states.to(states.dtype)
            if extra_attention_mask is None:
                extra_attention_mask = torch.ones(
                    extra.shape[:2], dtype=torch.int32, device=extra.device)
            states = torch.cat([extra, states], dim=1)
            mask = torch.cat([extra_attention_mask.to(torch.int32), mask],
                             dim=1)
        return states, mask

    def decode_hidden(self, decoder_input_ids, encoder_states,
                      cross_mask=None, decoder_mask=None,
                      decoder_segments=None, encoder_segments=None):
        """Decoder final hidden states (B, T, D), the pre-lm_head tap.
        decoder/encoder_segments enable packed rows (cross-attention
        restricted to the matching encoder segment)."""
        dec_embeds = self.embed(decoder_input_ids)
        return self.decoder(dec_embeds, encoder_states.to(dec_embeds.dtype),
                            self_mask=decoder_mask, cross_mask=cross_mask,
                            segments=decoder_segments,
                            enc_segments=encoder_segments)

    def embed(self, ids: torch.Tensor) -> torch.Tensor:
        """The ``shared`` embedding of ``ids``. Split over ``model`` by
        vocabulary, a rank looks up its rows (zeros for the others' ids)
        and the group sums (exact: one term is nonzero); its ``fsdp``
        block of the width is gathered first."""
        table = self.shared.embedding
        pl = getattr(self.shared, "placement", None)
        if pl is None or not any(pl["embedding"].spec):
            return F.embedding(ids.long(), table)
        table = col.fsdp_gather(table,
                                pl["embedding"].dim_of(col.FSDP_AXIS))
        if pl["embedding"].dim_of(col.MODEL_AXIS) is None:
            return F.embedding(ids.long(), table)
        rows = table.shape[0]
        local = ids.long() - col.model_index() * rows
        own = (local >= 0) & (local < rows)
        out = F.embedding(local.clamp(0, rows - 1), table).float()
        out = out * own[..., None]
        return col.model_all_reduce(out).to(table.dtype)

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

    def forward(self, input_ids=None, attention_mask=None,
                decoder_input_ids=None, input_embeds=None,
                extra_encoder_states=None, extra_attention_mask=None,
                decoder_mask=None):
        """The full seq2seq pass: ``encode``, then the decoder's logits."""
        states, mask = self.encode(input_ids, attention_mask, input_embeds,
                                   extra_encoder_states, extra_attention_mask)
        return self.decode_with_encoder_states(
            decoder_input_ids, states, cross_mask=mask,
            decoder_mask=decoder_mask)


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
