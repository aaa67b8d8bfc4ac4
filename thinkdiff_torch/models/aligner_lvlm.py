"""ThinkDiff-LVLM aligner: a trainable MLP projector on precomputed
Qwen2-VL hidden states conditions the frozen, encoder-less flan-t5 decoder,
trained to reconstruct the VLM's generated text (counterpart of
``MllamaT5EmbedDecoder`` in thinkdiff_tpu/models/aligner_lvlm.py), and its
inference variant ``MllamaT5EmbedDecoderWithEngine``, which owns a Qwen2-VL
engine: VLM generation -> hidden-state tap -> projector -> greedy T5 decode.

The model is built on its device (``device="cuda"`` by default; it raises
without a card, and the CPU runs the kernels' plain versions only when
asked with ``device="cpu"``). The frozen tower is ``frozen["t5"]``, a
``T5ForConditionalGeneration`` module holding the JAX-layout weights; the
trainable projector is the tree ``trainable["projector"]`` of f32 tensors.
``loss_fn(trainable, frozen, batch, rng)`` is the JAX function's
counterpart: the batch holds tensors on the model's device.

With ``load_pretrained`` set and a local flan-t5 checkpoint on disk the
frozen decoder is converted from it (``convert_t5``; the encoder is left
out, as the JAX model deletes it, after its final norm has seeded the
projector's ``t5_norm`` when the config asks); otherwise it draws seeded
random weights, as the JAX model does when no checkpoint is on disk.
"""

from __future__ import annotations

import logging
import math
import time
from typing import Any, Dict, List, Optional

import torch

from thinkdiff_torch import registry
from thinkdiff_torch.models.aligner_base import AlignerBase
from thinkdiff_torch.models.bridge import local_hf_dir, to_tensor
from thinkdiff_torch.models.t5 import (
    T5Config, ce_stats, cross_entropy_loss, shift_right)
from thinkdiff_torch.ops.chunked_ce import (
    chunked_head_ce_stats, chunked_head_cross_entropy)

logger = logging.getLogger(__name__)

# Qwen2-VL text hidden sizes
_VLM_HIDDEN = {
    "Qwen/Qwen2-VL-2B-Instruct": 1536,
    "Qwen/Qwen2-VL-7B-Instruct": 3584,
}


@registry.register_model("mllama-vllm-t5-embed-decoder-2")
class MllamaT5EmbedDecoder(AlignerBase):
    default_model_type = "pretrain_mllama_vllm_t5_embed_decoder_2"
    PRETRAINED_MODEL_CONFIG_DICT = {
        "pretrain_mllama_vllm_t5_embed_decoder_2":
            "configs/models/mllama_vllm_t5_embed_decoder_2.yaml",
    }
    DEFAULT_CONFIG = {
        "mm_projector_type": "mlp2x_gelu_t5_norm",
        "dtype": "bfloat16",
        "max_txt_len": 128,
        "mllama_output_embeddings_drop_rate": None,
        "layer_norm_reinit_weight_with_language_encoder": False,
    }

    def __init__(self, cfg: Optional[Dict[str, Any]] = None, seed: int = 0,
                 device="cuda"):
        super().__init__(cfg, seed, device)
        cfg = self.cfg
        self.vlm_hidden = int(
            cfg.get("vlm_hidden_size")
            or _VLM_HIDDEN.get(
                cfg.get("mllama_pretrained_model_name_or_path", ""), 1536))
        self.drop_rate = cfg.get("mllama_output_embeddings_drop_rate", None)
        self.forward_type = cfg.get("forward_type", None)
        if self.forward_type not in (None, "forward_inner"):
            raise ValueError(
                f"Unsupported forward_type '{self.forward_type}' "
                "(the reference implements only 'forward_inner')")
        self._build_params(seed)

    def _build_params(self, seed: int) -> None:
        gen = torch.Generator(device=self.device).manual_seed(seed)
        t5, encoder_norm = self._frozen_t5(gen, encoder=False)
        self.frozen = {"t5": t5}
        params = self.projector.init_params(self.vlm_hidden, gen, self.device)
        # with random weights there is no encoder final norm to copy into
        # t5_norm: it keeps its init of ones
        self._reinit_t5_norm(params, encoder_norm)
        self.trainable = {"projector": params}

    def get_vlm_decode_fn(self):
        """token ids -> text with the VLM tokenizer from local files, or the
        ``vlm_decode_fn`` attribute when one is set; None without either."""
        override = self.__dict__.get("vlm_decode_fn")
        if override is not None:
            return override
        path = self.cfg.get("mllama_pretrained_model_name_or_path", None)
        local = local_hf_dir(path) if path else None
        if local is None:
            logger.warning("VLM tokenizer unavailable: %s is not on disk", path)
            return None
        try:
            from transformers import AutoTokenizer

            tok = AutoTokenizer.from_pretrained(local, local_files_only=True)
        except (ImportError, OSError, ValueError) as e:
            logger.warning("VLM tokenizer unavailable for %s: %s", path, e)
            return None
        return lambda ids: tok.decode(ids, skip_special_tokens=True)

    # -- compute ------------------------------------------------------------
    def project(self, trainable, embeds: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """VLM hidden states (B, S, Dv) -> T5-space tokens (B, S, d_model),
        with the optional input dropout drawn from ``generator``."""
        x = embeds.to(self.dtype)
        if self.drop_rate and generator is not None:
            rate = float(self.drop_rate)
            keep = torch.rand(x.shape, generator=generator,
                              device=x.device) < 1.0 - rate
            x = torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))
        return self.projector(trainable["projector"], x)

    def _decode(self, trainable, frozen, batch, generator):
        proj = self.project(trainable, batch["embeds"], generator)
        labels = batch["labels"]
        # packed rows carry explicit decoder inputs: a global shift_right
        # would leak segment i's last token into segment i+1's start
        dec_ids = batch.get("decoder_input_ids")
        if dec_ids is None:
            dec_ids = shift_right(labels)
        t5 = frozen["t5"]
        hidden = t5.decode_hidden(
            dec_ids, proj, cross_mask=batch.get("embed_mask"),
            decoder_segments=batch.get("dec_segments"),
            encoder_segments=batch.get("enc_segments"))
        return t5, hidden, labels

    def loss_fn(self, trainable, frozen, batch, rng=None) -> torch.Tensor:
        """batch: embeds (B, S, Dv), embed_mask (B, S), labels (B, T) with
        -100 padding, and for packed rows decoder_input_ids, dec_segments,
        enc_segments. ``rng``: a torch.Generator for the input dropout.
        The lm_head and CE run over token chunks (``chunked_ce``, default
        32; 0 computes the full logits)."""
        t5, hidden, labels = self._decode(trainable, frozen, batch, rng)
        chunk = int(self.cfg.get("chunked_ce", 32) or 0)
        if chunk and not self.t5_cfg.tie_word_embeddings:
            return chunked_head_cross_entropy(hidden, labels, t5.lm_head,
                                              dtype=self.dtype, chunk=chunk)
        return cross_entropy_loss(t5.logits(hidden), labels)

    @torch.no_grad()
    def eval_metrics_fn(self, trainable, frozen, batch):
        """(loss, n_correct, n_tokens), correctness being teacher-forced
        next-token accuracy."""
        t5, hidden, labels = self._decode(trainable, frozen, batch, None)
        if not self.t5_cfg.tie_word_embeddings:
            return chunked_head_ce_stats(
                hidden, labels, t5.lm_head, dtype=self.dtype,
                chunk=int(self.cfg.get("chunked_ce", 32) or 32))
        return ce_stats(t5.logits(hidden), labels)

    @torch.no_grad()
    def calibrate_w8a8(self, batches, alpha: float = 0.5) -> Dict[str, Any]:
        """SmoothQuant channel equalization of the frozen w8a8 tower from a
        few training batches (``embeds``, ``labels``, optional
        ``embed_mask``; numpy or tensors): the per-channel activation maxima
        of every w8a8 layer through the full-logits decode
        (``decode_with_encoder_states`` on shift_right(labels), as JAX
        collects them), then ``equalize_quantized_tree`` folds them into the
        weights and ``input_scale``s, in place. Run once after loading real
        flan-t5 weights; repeated calibrations compose. Returns the
        stats."""
        from thinkdiff_torch.models.bridge import load_params, tree_of
        from thinkdiff_torch.ops.quant import (
            collect_act_stats, equalize_quantized_tree, w8a8_layers)

        t5 = self.frozen["t5"]
        if not self.quantize_frozen or not w8a8_layers(t5):
            raise ValueError("calibrate_w8a8 needs a w8a8 frozen tower "
                             "(quantize_frozen: int8_dyn)")
        dev = lambda x: None if x is None else to_tensor(x).to(self.device)
        stats = None
        for batch in batches:
            proj = self.project(self.trainable, dev(batch["embeds"]))
            stats = collect_act_stats(
                t5, shift_right(dev(batch["labels"])), proj,
                method="decode_with_encoder_states",
                cross_mask=dev(batch.get("embed_mask")), stats=stats)
        load_params(t5, equalize_quantized_tree(
            tree_of(t5, lambda _, t: t), stats, alpha))
        return stats

    @torch.no_grad()
    def greedy_decode(self, proj: torch.Tensor, embed_mask=None,
                      max_new_tokens: int = 32) -> torch.Tensor:
        """Greedy T5 decode conditioned on projected states (B, S, d_model):
        decoder start id 0, every step recomputes the whole prefix (no KV
        cache, as the JAX package) and appends the argmax of the last
        position. Returns the (B, max_new_tokens) new ids."""
        t5 = self.frozen["t5"]
        # int32 once here, the flash kernel's type, not once a layer a step
        mask = None if embed_mask is None else to_tensor(embed_mask).to(
            self.device, torch.int32)
        dec = torch.zeros((proj.shape[0], 1), dtype=torch.long,
                          device=self.device)
        for _ in range(max_new_tokens):
            logits = t5.decode_with_encoder_states(dec, proj, cross_mask=mask)
            nxt = logits[:, -1].argmax(dim=-1)
            dec = torch.cat([dec, nxt[:, None]], dim=1)
        return dec[:, 1:]

    @torch.no_grad()
    def generate(self, embeds, embed_mask=None, max_new_tokens: int = 32):
        """Greedy T5 decode conditioned on projected VLM hidden states
        (B, S, Dv): the reference's ``generate``, recompute-per-step."""
        proj = self.project(self.trainable, to_tensor(embeds).to(self.device))
        return self.greedy_decode(proj, embed_mask, max_new_tokens)

    @torch.no_grad()
    def get_embed_from_hidden(self, hidden_states, rng=None):
        """Aligned conditioning tokens from VLM hidden states (the tail of
        the reference's ``get_embed``)."""
        return self.project(self.trainable,
                            to_tensor(hidden_states).to(self.device), rng)


@registry.register_model("mllama-vllm-t5-embed-decoder-5")
class MllamaT5EmbedDecoderWithEngine(MllamaT5EmbedDecoder):
    """The inference variant that owns a Qwen2-VL generation engine
    (counterpart of the JAX class of the same name): ``get_text`` (VLM text
    only), ``generate`` (VLM -> projector -> greedy T5 per sample) and
    ``get_embed`` (VLM -> projector). The engine is built lazily from the
    model config (``EmbedEngine.from_config``, local checkpoint files) on
    first use, or passed in as ``engine``; any object with the engine's
    ``generate`` and ``num_system_tokens`` serves."""

    def __init__(self, cfg: Optional[Dict[str, Any]] = None, seed: int = 0,
                 device="cuda", engine=None):
        super().__init__(cfg, seed, device)
        self._engine = engine
        self.t5_tokenizer = None
        # seconds of the last generate(): VLM, projector, T5 decode (each
        # ending in a device sync) and the number of T5 decode steps
        self.last_phase_times: Dict[str, float] = {}

    @property
    def engine(self):
        if self._engine is None:
            from thinkdiff_torch.engines.embed_engine import EmbedEngine

            self._engine = EmbedEngine.from_config(self.cfg,
                                                   device=self.device)
        return self._engine

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @staticmethod
    def _vllm_inputs_to_samples(mllama_inputs) -> Dict[str, List[Any]]:
        """vLLM-style pre-formatted inputs -> engine samples: one dict or a
        list of ``{"prompt": str, "multi_modal_data": {"image": PIL | [PIL,
        ...]}}`` or plain prompt strings (text-only: image None). Prompts
        are tokenized as they are (no chat template)."""
        if isinstance(mllama_inputs, dict):
            mllama_inputs = [mllama_inputs]
        prompts, images = [], []
        for entry in mllama_inputs:
            if isinstance(entry, str):
                prompts.append(entry)
                images.append(None)
            else:
                prompts.append(entry["prompt"])
                images.append(entry.get("multi_modal_data", {}).get("image"))
        return {"raw_prompts": prompts, "images": images}

    def get_text(self, mllama_inputs, embedding_type: str = "both",
                 output_len_factor: int = 1, need_process: bool = True,
                 max_new_tokens: int = 128, **generate_kwargs) -> List[str]:
        """VLM text generation only. ``need_process=True`` takes
        {"answers": [...], "images": [...]} and renders the chat template;
        ``need_process=False`` takes pre-formatted vLLM-style inputs,
        text-only prompts included. ``embedding_type`` and
        ``output_len_factor`` are accepted and unused, as in the
        reference."""
        samples = (mllama_inputs if need_process
                   else self._vllm_inputs_to_samples(mllama_inputs))
        return self.engine.generate(samples,
                                    max_new_tokens=max_new_tokens).texts

    def _hidden(self, result, i: int, embedding_type: str) -> torch.Tensor:
        """Sample i's VLM hidden states (S, Dv) of ``embedding_type``."""
        inp = to_tensor(result.prompt_hidden_states[i])
        out = to_tensor(result.hidden_states[i])
        if embedding_type == "both":
            return torch.cat([inp, out], dim=0)
        if embedding_type == "input_embed":
            return inp
        if embedding_type == "input_no_system":
            return inp[self.engine.num_system_tokens:]
        if embedding_type == "output_embed":
            return out
        raise ValueError(embedding_type)

    @torch.no_grad()
    def generate(self, samples, embedding_type: str = "both",
                 output_len_factor: int = 1, max_new_tokens: int = 128,
                 t5_max_new_tokens: int = 32, rng=None):
        """VLM generate -> hidden-state tap -> projector -> per-sample greedy
        T5 decode. Returns (T5 ids per sample, each cut after its first EOS
        ``t5_eos_token_id`` (default 1), the T5 texts ("" without a local
        tokenizer), the VLM texts): the full per-sample list, where the
        reference returns only its last sample's decode."""
        if embedding_type not in ("both", "input_embed", "output_embed"):
            raise ValueError(embedding_type)
        t0 = time.perf_counter()
        result = self.engine.generate(samples, max_new_tokens=max_new_tokens)
        times = {"vlm": time.perf_counter() - t0, "projector": 0.0,
                 "t5": 0.0, "t5_steps": 0}
        if self.t5_tokenizer is None:
            self.t5_tokenizer = self.get_t5_tokenizer()
        eos_id = int(self.cfg.get("t5_eos_token_id", 1))
        outputs_list, t5_texts = [], []
        for i in range(len(result.hidden_states)):
            hid = self._hidden(result, i, embedding_type)
            t0 = time.perf_counter()
            proj = self.project(self.trainable, hid[None].to(self.device))
            self._sync()
            t1 = time.perf_counter()
            ids = self.greedy_decode(proj, None, t5_max_new_tokens)[0].tolist()
            times["projector"] += t1 - t0
            times["t5"] += time.perf_counter() - t1
            times["t5_steps"] += t5_max_new_tokens
            if eos_id in ids:
                ids = ids[: ids.index(eos_id) + 1]
            outputs_list.append(ids)
            t5_texts.append(
                self.t5_tokenizer.decode([t for t in ids if t != eos_id],
                                         skip_special_tokens=True)
                if self.t5_tokenizer is not None else "")
        self.last_phase_times = times
        return outputs_list, t5_texts, result.texts

    @torch.no_grad()
    def get_embed(self, samples, embedding_type: str = "output_embed",
                  max_new_tokens: int = 128, rng=None):
        """images + prompts -> VLM generate -> hidden-state tap ->
        projector: (a list of (S, d_model) conditioning tensors on the
        model's device, the engine's result). ``embedding_type`` in both,
        input_embed, input_no_system (the prompt without its system turn:
        ``engine.num_system_tokens``), output_embed."""
        result = self.engine.generate(samples, max_new_tokens=max_new_tokens)
        conds = [self.project(self.trainable,
                              self._hidden(result, i, embedding_type)[None]
                              .to(self.device), rng)[0]
                 for i in range(len(result.hidden_states))]
        return conds, result


def lvlm_text_launches(t5_cfg: T5Config, embed_lens: List[int],
                       steps: int) -> int:
    """GEMV (``int8_matmul``) launches of a weight-only greedy T5 decode of
    ``steps`` steps per sample, one sample per entry of ``embed_lens`` (its
    conditioning length): at step i the decoder holds i + 1 tokens, <= 32
    rows, so each of its weight-only layers takes the GEMV, and the cross
    k/v projections do too when the conditioning has <= 32 rows."""
    from thinkdiff_torch.ops.int8_matmul import GEMV_ROWS

    if t5_cfg.quant_int8 is not True:
        raise ValueError("lvlm_text_launches counts the weight-only layout")
    if steps > GEMV_ROWS:
        raise ValueError(f"{steps} steps exceed the GEMV's {GEMV_ROWS} rows")
    n = t5_cfg.num_decoder_layers
    ffn = (2 if t5_cfg.fused_proj else 3) if t5_cfg.is_gated else 2
    self_attn = 2 if t5_cfg.fused_proj else 4       # qkv | q, k, v; o
    per_step = n * (self_attn + 2 + ffn)            # + cross q, o
    head = 0 if t5_cfg.tie_word_embeddings else 1
    total = 0
    for s in embed_lens:
        cross_kv = (1 if t5_cfg.fused_proj else 2) if s <= GEMV_ROWS else 0
        total += steps * (per_step + n * cross_kv + head)
    return total


def get_embed_launches(model, prompt_lens: List[int], max_tokens: int,
                       vision_calls: int = 1) -> Dict[str, int]:
    """Flash forward, RMSNorm and w8a8 GEMM launches of ``model.get_embed``
    on a static batch (``EmbedEngine.generate``): prompts of
    ``prompt_lens`` tokens, ``max_tokens`` generated each, for an engine
    whose language model is w8a8 with fused projections and its own
    lm_head, whose vision tower is bf16 and whose sampler is exact.

    Each of ``vision_calls`` vision passes runs one flash forward a block.
    The prompt runs in chunks of ``prefill_chunk`` (their attention, like
    the decode steps', is the plain cache attention) or in one causal
    flash pass a layer; then max_tokens - 1 single-token decode steps.
    Every LM forward runs two RMSNorms a layer and the final norm, and four
    w8a8 GEMMs a layer (qkv, o, gate_up, down); the first token and every
    decode step take the lm_head's logits, one more GEMM; the projector's
    trailing t5_norm is one RMSNorm a sample."""
    engine, cfg = model.engine, model.engine.cfg
    if (cfg.quant_int8 != "w8a8" or not cfg.fused_proj
            or cfg.tie_word_embeddings or cfg.vision.quant_int8
            or engine.sampler != "exact"):
        raise ValueError("get_embed_launches counts a w8a8 LM with fused "
                         "projections and an lm_head, a bf16 vision tower "
                         "and the exact sampler")
    n = cfg.num_layers
    longest = max(prompt_lens)
    flash = cfg.vision.depth * vision_calls
    if engine.prefill_chunk:
        bucket = min(1 << max(6, (longest - 1).bit_length()),
                     engine.max_prompt_len)
        chunks = -(-longest // min(engine.prefill_chunk, bucket))
    else:
        chunks, flash = 1, flash + n
    forwards = chunks + max_tokens - 1
    norms = len(prompt_lens) if model.projector.use_t5_norm else 0
    return {"flash_attention_fwd": flash,
            "rmsnorm": forwards * (2 * n + 1) + norms,
            "s8_matmul": forwards * 4 * n + max_tokens}


def flux_launches(cfg, steps: int, clip_layers: int) -> Dict[str, int]:
    """Flash forward and RMSNorm launches of LVLM inference into FLUX: the
    CLIP-L pooled embedding (computed once for the prompt and batch, one
    causal attention a layer), then ``steps`` Euler steps of the transformer
    of ``cfg`` (models/flux.FluxConfig): one joint attention a block, and
    q/k norms of the image and text streams in a double block (4) and of
    the joint stream in a single block (2)."""
    blocks = cfg.num_double_layers + cfg.num_single_layers
    return {"flash_attention_fwd": steps * blocks + clip_layers,
            "rmsnorm": steps * (4 * cfg.num_double_layers
                                + 2 * cfg.num_single_layers)}


def step_launches(t5_cfg: T5Config, dec_len: int, chunk: int) -> Dict[str, int]:
    """Kernel launches of one training step of the aligner (forward and
    backward; projector, decoder, chunked lm_head + CE) for a w8a8 fused or
    bf16 decoder, from its configuration: decoder rows of ``dec_len``
    tokens, CE chunks of ``chunk`` tokens.

    Only the projector is trained, so the gradient reaches the decoder
    through the cross-attention keys and values: block 0's self-attention
    (its norm, projections and attention) and the query projection of its
    cross-attention see no gradient and launch no backward kernel, while
    every later block's whole input does. Each cross-attention's backward
    runs the dq kernel as well, since it computes the delta that the dk/dv
    kernel reads. Every lm_head chunk runs its forward twice (the
    checkpointed chunk is recomputed in the backward)."""
    n = t5_cfg.num_decoder_layers
    chunks = math.ceil(dec_len / chunk) if chunk else 1
    out = {"flash_attention_fwd": 2 * n,
           "flash_attention_dq": 2 * n - 1,
           "flash_attention_dkv": 2 * n - 1,
           # 3 norms a block, the final norm, the projector's t5_norm
           "rmsnorm": 3 * n + 2}
    if t5_cfg.quant_int8 == "w8a8":
        if not t5_cfg.fused_proj:
            raise ValueError("step_launches counts the fused w8a8 layout")
        # qkv, o | q, kv_fused, o | wi_fused, wo
        head = (2 if chunk else 1) * chunks
        out["s8_matmul"] = 7 * n + head
        # block 0: kv_fused, cross o, wi_fused, wo; later blocks all 7
        out["s8_matmul_bwd"] = 4 + 7 * (n - 1) + chunks
    return out
