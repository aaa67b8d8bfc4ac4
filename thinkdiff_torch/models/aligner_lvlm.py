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

Checkpoint conversion from HF (``convert_t5``) is not ported yet: with
``load_pretrained`` set and a local flan-t5 checkpoint present the model
refuses to build; without one it draws seeded random weights, as the JAX
model does when no checkpoint is on disk.
"""

from __future__ import annotations

import logging
import math
import time
from typing import Any, Dict, List, Optional

import torch

from thinkdiff_torch import registry, resolve_device
from thinkdiff_torch.core.config import model_default_config_path
from thinkdiff_torch.core.optim import tree_map
from thinkdiff_torch.models.bridge import (
    local_hf_dir, local_hf_state_dict, to_numpy, to_tensor, unflatten)
from thinkdiff_torch.models.projector import (
    build_vision_projector, convert_projector_torch, export_projector_torch)
from thinkdiff_torch.models.qdense import QDense
from thinkdiff_torch.models.t5 import (
    T5Config, T5ForConditionalGeneration, ce_stats, cross_entropy_loss,
    shift_right)
from thinkdiff_torch.ops.chunked_ce import (
    chunked_head_ce_stats, chunked_head_cross_entropy)
from thinkdiff_torch.ops.quant import quantize_weight

logger = logging.getLogger(__name__)

# Qwen2-VL text hidden sizes
_VLM_HIDDEN = {
    "Qwen/Qwen2-VL-2B-Instruct": 1536,
    "Qwen/Qwen2-VL-7B-Instruct": 3584,
}
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}
INIT_STD = 0.05


@torch.no_grad()
def init_frozen_t5_(t5: T5ForConditionalGeneration,
                    generator: torch.Generator) -> None:
    """Seeded random weights on the module's device, as the JAX package's
    ``quantize_leaves_on_device``: every float leaf N(0, 0.05); an int8
    QDense draws its (K, N) kernel N(0, 0.05) in f32 and keeps only the
    per-column quantization, one layer at a time, so the full-precision
    tower never exists whole."""
    for module in t5.modules():
        if isinstance(module, QDense) and module.quant:
            w = torch.randn((module.in_dim, module.features),
                            generator=generator, device=generator.device)
            qw = quantize_weight(w * INIT_STD)
            module.kernel_q.copy_(qw["q"])
            module.kernel_scale.copy_(qw["scale"])
            module.sync_train_layout()
            continue
        for p in module.parameters(recurse=False):
            p.copy_(torch.randn(p.shape, generator=generator,
                                device=generator.device) * INIT_STD)


@registry.register_model("mllama-vllm-t5-embed-decoder-2")
class MllamaT5EmbedDecoder:
    default_model_type = "pretrain_mllama_vllm_t5_embed_decoder_2"
    PRETRAINED_MODEL_CONFIG_DICT = {
        "pretrain_mllama_vllm_t5_embed_decoder_2":
            "configs/models/mllama_vllm_t5_embed_decoder_2.yaml",
    }
    default_config_path = classmethod(model_default_config_path)
    DEFAULT_CONFIG = {
        "mm_projector_type": "mlp2x_gelu_t5_norm",
        "dtype": "bfloat16",
        "max_txt_len": 128,
        "mllama_output_embeddings_drop_rate": None,
        "layer_norm_reinit_weight_with_language_encoder": False,
    }

    def __init__(self, cfg: Optional[Dict[str, Any]] = None, seed: int = 0,
                 device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg = {**self.DEFAULT_CONFIG, **(cfg or {})}
        self.dtype = _DTYPES[cfg.get("dtype", "bfloat16")]
        qmode = cfg.get("quantize_frozen", None)
        if qmode not in (None, "int8", "int8_dyn"):
            raise ValueError(f"Unsupported quantize_frozen '{qmode}'")
        self.quantize_frozen = qmode is not None
        self.t5_cfg = T5Config(**{
            **dict(dtype=self.dtype, dropout_rate=0.0,
                   quant_int8={"int8": True, "int8_dyn": "w8a8"}.get(
                       qmode, False)),
            **dict(cfg.get("t5_config", {}))})
        self.vlm_hidden = int(
            cfg.get("vlm_hidden_size")
            or _VLM_HIDDEN.get(
                cfg.get("mllama_pretrained_model_name_or_path", ""), 1536))
        self.projector = build_vision_projector(
            cfg.get("mm_projector_type", "mlp2x_gelu_t5_norm"),
            self.t5_cfg.d_model, dtype=self.dtype)
        self.drop_rate = cfg.get("mllama_output_embeddings_drop_rate", None)
        self.forward_type = cfg.get("forward_type", None)
        if self.forward_type not in (None, "forward_inner"):
            raise ValueError(
                f"Unsupported forward_type '{self.forward_type}' "
                "(the reference implements only 'forward_inner')")
        self._build_params(seed)

    def _build_params(self, seed: int) -> None:
        path = self.cfg.get("text_pretrained_model_name_or_path",
                            "google/flan-t5-xxl")
        if (self.cfg.get("load_pretrained", True)
                and local_hf_state_dict(path) is not None):
            raise NotImplementedError(
                f"a T5 checkpoint is on disk at {path}, but HF conversion is "
                "not ported yet")
        gen = torch.Generator(device=self.device).manual_seed(seed)
        t5 = T5ForConditionalGeneration(self.t5_cfg, device=self.device)
        init_frozen_t5_(t5, gen)
        self.frozen = {"t5": t5}
        # with random weights there is no encoder final norm to copy into
        # t5_norm (layer_norm_reinit_weight_with_language_encoder): it
        # keeps its init of ones
        self.trainable = {"projector": self.projector.init_params(
            self.vlm_hidden, gen, self.device)}

    @classmethod
    def from_config(cls, cfg, device="cuda"):
        return cls(cfg, device=device)

    def load_checkpoint_from_config(self, cfg) -> None:
        """Loads the trainable weights the config's ``ckpt`` names."""
        ckpt = cfg.get("ckpt", None) if cfg else None
        if ckpt:
            self.load_checkpoint(ckpt)

    def load_checkpoint(self, path: str) -> None:
        """Trainable weights from a ``.pth``: the port's checkpoint (its
        ``model`` holds the trainable leaves under their JAX names) or the
        reference's (``mm_projector.*`` entries, raw or under ``model``)."""
        sd = torch.load(path, map_location="cpu", weights_only=True)
        if isinstance(sd, dict) and isinstance(sd.get("model"), dict):
            sd = sd["model"]
        if any("mm_projector" in k for k in sd):
            self.load_trainable(self.convert_reference_checkpoint(sd))
        else:
            self.load_trainable(unflatten(sd))
        logger.info("Loaded trainable checkpoint from %s", path)

    def trainable_params(self) -> Dict[str, Any]:
        return self.trainable

    def load_trainable(self, params: Dict[str, Any]) -> None:
        """A JAX-layout trainable tree (numpy or torch leaves), copied."""
        self.trainable = tree_map(
            lambda x: to_tensor(x).to(self.device, copy=True), params)

    def export_trainable(self) -> Dict[str, Any]:
        """Inverse of ``load_trainable``: the trainable tree as numpy. The
        frozen tower's is ``bridge.params_of(frozen["t5"])``."""
        return tree_map(to_numpy, self.trainable)

    def convert_reference_checkpoint(self, sd: Dict) -> Dict[str, Any]:
        """The reference's trainable checkpoint (its ``mm_projector.*``
        entries) -> the trainable tree, numpy leaves (``load_trainable``
        takes it)."""
        return {"projector": convert_projector_torch(
            {k: v for k, v in sd.items() if "mm_projector" in k})}

    def export_reference_checkpoint(self, trainable: Dict) -> Dict:
        """Inverse of ``convert_reference_checkpoint``: a state dict the
        reference's PyTorch stack loads."""
        return export_projector_torch(
            trainable["projector"],
            self.cfg.get("mm_projector_type", "mlp2x_gelu_t5_norm"))

    def get_t5_tokenizer(self):
        """The T5 tokenizer from local files only; None when they are not on
        disk (nothing is downloaded, and without local files transformers
        is not even imported)."""
        path = self.cfg.get("text_pretrained_model_name_or_path",
                            "google/flan-t5-xxl")
        local = local_hf_dir(path)
        if local is None:
            logger.warning("T5 tokenizer unavailable: %s is not on disk", path)
            return None
        try:
            from transformers import AutoTokenizer

            return AutoTokenizer.from_pretrained(local, local_files_only=True)
        except (ImportError, OSError, ValueError) as e:
            # no transformers, or incomplete files
            logger.warning("T5 tokenizer unavailable for %s: %s", path, e)
            return None

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
