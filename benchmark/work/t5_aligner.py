"""The work of one training step of ThinkDiff-LVLM's aligner: the
projector (``mlp2x_gelu_t5_norm``) into the frozen flan-t5 decoder, the
untied lm_head and the token-mean cross entropy, AdamW on the projector.

``step_ops`` counts the operations the step requires from the samples'
UNPADDED lengths: the forward, the input gradients through the frozen
decoder back to the cross-attention keys and values of every block, and
the projector's weight gradients. Block 0's self-attention and its
cross-attention's query side see no gradient; nothing is counted twice
(the lm_head chunks the program recomputes in its backward are not
required work). Elementwise work (norms, GELU, softmax) is left out.

``step_calls`` lists the attention calls the step makes at the PADDED
batch shapes the kernels are given: a causal self-attention with the
shared relative bias and a cross-attention under the embed mask in every
block, and the backward of all of them but block 0's self-attention."""

from __future__ import annotations

from typing import Iterable, List

from benchmark.work import attention


def step_ops(t5: dict, vlm_hidden: int, label_lens: Iterable[int],
             splits: Iterable[int]) -> float:
    d, dff = t5["d_model"], t5["d_ff"]
    inner = t5["num_heads"] * t5["d_kv"]
    n, vocab = t5["num_decoder_layers"], t5["vocab_size"]
    total = 0.0
    for tok, s in zip(label_lens, splits):
        tok, s = float(tok), float(s)
        self_pairs = tok * (tok + 1) / 2
        # per block, forward: self q, k, v, o; cross q, o on the decoder
        # tokens; cross k, v on the embed tokens; gated FFN (wi_0, wi_1, wo)
        lin_self = 2 * tok * 4 * d * inner
        lin_cross_q_o = 2 * tok * 2 * d * inner
        lin_cross_kv = 2 * s * 2 * d * inner
        lin_ffn = 2 * tok * 3 * d * dff
        att_self = 4 * inner * self_pairs
        att_cross = 4 * inner * tok * s
        block_fwd = (lin_self + lin_cross_q_o + lin_cross_kv + lin_ffn
                     + att_self + att_cross)
        head = 2 * tok * d * vocab
        proj_fwd = 2 * s * (vlm_hidden * d + d * d)
        fwd = proj_fwd + n * block_fwd + head
        # backward: input gradients through the frozen weights (one product
        # per forward product), attention's four products per two
        block_bwd = (lin_self + lin_cross_q_o + lin_cross_kv + lin_ffn
                     + 2 * att_self + 2 * att_cross)
        # block 0: no self-attention gradient, no cross query gradient
        # (dQ and the q projection's input gradient), dK and dV still
        block0_bwd = (lin_cross_q_o / 2 + lin_cross_kv + lin_ffn
                      + 1.5 * att_cross)
        proj_bwd = 2 * s * (vlm_hidden * d + d * d) + 2 * s * d * d
        bwd = (n - 1) * block_bwd + block0_bwd + head + proj_bwd
        total += fwd + bwd
    return total


def step_calls(t5: dict, batch: int, dec_len: int, enc_len: int) -> List[dict]:
    h, dk, n = t5["num_heads"], t5["d_kv"], t5["num_decoder_layers"]
    self_f = attention.forward(batch, h, dec_len, dec_len, dk, causal=True,
                               bias_heads=h)
    cross_f = attention.forward(batch, h, dec_len, enc_len, dk, kv_mask=True)
    self_b = attention.backward(batch, h, dec_len, dec_len, dk, causal=True,
                                bias_heads=h)
    cross_b = attention.backward(batch, h, dec_len, enc_len, dk, kv_mask=True)
    return ([self_f] * n + [cross_f] * n + [self_b] * (n - 1)
            + [cross_b] * n)
