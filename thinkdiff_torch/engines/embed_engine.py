"""Qwen2-VL embedding engine in PyTorch (counterpart of
thinkdiff_tpu/engines/embed_engine.py): images + prompts in, generated text
and per-token ``model.norm`` hidden states out — the role the reference's
forked vLLM plays (``LLM(..., return_hidden_states=True)``).

Pipeline per batch:
  host:   smart-resize (PIL, uint8 out), chat-template tokenize, M-RoPE
          position ids
  device: normalize + patchify -> vision tower (flash kernel, weight-only
          or w8a8 projections) -> one-shot bucketed prefill into a dense KV
          cache (flash kernel; w8a8 projections through the s8 GEMM kernel;
          RMSNorm kernel) -> decode loop with temperature/top-p sampling
          over the dense cache -> bf16 hidden states of prompt and
          generated tokens.

This port serves the dense static batch: at most 32 slots, every request
admitted at once. The paged KV pool, chunked prefill, prefill-ahead,
pipelined EOS accounting and the fused Gumbel sampler raise
NotImplementedError, naming the ROADMAP.md slice that brings them.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from thinkdiff_torch import registry
from thinkdiff_torch.models.bridge import load_params
from thinkdiff_torch.models.qwen2_vl import (
    Qwen2VLConfig, Qwen2VLModel, Qwen2VisionTower, get_mrope_position_ids,
    vision_cos_sin, vision_rot_pos_emb,
)

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)

DEFAULT_SYSTEM = "You are a helpful assistant."

MAX_DENSE_SLOTS = 32
_SLICE_2 = "ROADMAP.md, port slice 2 (paged serving)"


def _not_in_slice(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet: {_SLICE_2}")


# ---------------------------------------------------------------------------
# Host-side helpers (identical to the JAX package's)
# ---------------------------------------------------------------------------

def render_chat_prompt(system_prompt: str, text: str, n_images: int,
                       fmt: str = "qwen2_vl") -> str:
    """Chat template string for one user turn with ``n_images`` leading
    images. ``qwen2_vl`` byte-matches HF ``apply_chat_template``;
    ``internvl`` and ``generic`` are single user turns without a system
    turn (the reference's per-VLM message shapes)."""
    vision_parts = "".join(
        "<|vision_start|><|image_pad|><|vision_end|>" for _ in range(n_images)
    )
    if fmt == "internvl":
        return (
            f"<|im_start|>user\n{vision_parts}\n{text}<|im_end|>\n"
            f"<|im_start|>assistant\n"
        )
    if fmt == "generic":
        return (
            f"<|im_start|>user\n{vision_parts}{text}<|im_end|>\n"
            f"<|im_start|>assistant\n"
        )
    return (
        f"<|im_start|>system\n{system_prompt}<|im_end|>\n"
        f"<|im_start|>user\n{vision_parts}{text}<|im_end|>\n"
        f"<|im_start|>assistant\n"
    )


_QWEN2_VL_IDS = ("Qwen2-VL-2B-Instruct", "Qwen2-VL-7B-Instruct",
                 "Qwen2-VL-72B-Instruct")
_LLAVA_LEADING_SPACE_IDS = ("llava-v1.6-mistral-7b-hf", "llava-1.5-7b-hf")


def prompt_format_for_model(model_id: str) -> str:
    if any(q in str(model_id) for q in _QWEN2_VL_IDS):
        return "qwen2_vl"
    if "InternVL" in str(model_id):
        return "internvl"
    return "generic"


def smart_resize(height: int, width: int, factor: int = 28,
                 min_pixels: int = 56 * 56, max_pixels: int = 14 * 14 * 4 * 1280
                 ) -> Tuple[int, int]:
    """Resize target dims: multiples of ``factor`` within the pixel budget."""
    if height < factor or width < factor:
        scale = factor / min(height, width)
        height, width = math.ceil(height * scale), math.ceil(width * scale)
    h_bar = round(height / factor) * factor
    w_bar = round(width / factor) * factor
    if h_bar * w_bar > max_pixels:
        beta = math.sqrt((height * width) / max_pixels)
        h_bar = math.floor(height / beta / factor) * factor
        w_bar = math.floor(width / beta / factor) * factor
    elif h_bar * w_bar < min_pixels:
        beta = math.sqrt(min_pixels / (height * width))
        h_bar = math.ceil(height * beta / factor) * factor
        w_bar = math.ceil(width * beta / factor) * factor
    return max(h_bar, factor), max(w_bar, factor)


def resize_image_uint8(image, factor: int = 28, min_pixels: int = 56 * 56,
                       max_pixels: int = 12845056
                       ) -> Tuple[np.ndarray, Tuple[int, int]]:
    """PIL/array image -> (uint8 (H, W, 3) smart-resized RGB, (H, W)). The
    host's only vision work; normalize and patchify run on the device."""
    from PIL import Image

    if not isinstance(image, Image.Image):
        image = Image.fromarray(np.asarray(image))
    image = image.convert("RGB")
    h_bar, w_bar = smart_resize(image.height, image.width, factor,
                                min_pixels, max_pixels)
    image = image.resize((w_bar, h_bar), Image.BICUBIC)
    return np.asarray(image, np.uint8), (h_bar, w_bar)


def patchify_normalize(imgs: torch.Tensor, patch_size: int = 14,
                       merge: int = 2, temporal: int = 2) -> torch.Tensor:
    """uint8 (B, H, W, 3) -> f32 patches (B, N, C*T*P*P) on the images'
    device: the HF Qwen2VLImageProcessor math (CLIP mean/std, frame
    repeated over the temporal patch, patch vector order (C, T, Ph, Pw),
    sequence order (t, H/m, W/m, m, m))."""
    b, h_bar, w_bar, _ = imgs.shape
    mean = torch.as_tensor(CLIP_MEAN, device=imgs.device)
    std = torch.as_tensor(CLIP_STD, device=imgs.device)
    x = imgs.float() / 255.0
    x = (x - mean) / std                                       # (B, H, W, C)
    x = x.permute(0, 3, 1, 2)                                  # (B, C, H, W)
    x = x[:, None].expand(b, temporal, 3, h_bar, w_bar)        # (B, T, C, H, W)
    grid_h, grid_w = h_bar // patch_size, w_bar // patch_size
    p = patch_size
    x = x.reshape(b, 1, temporal, 3, grid_h // merge, merge, p,
                  grid_w // merge, merge, p)
    x = x.permute(0, 1, 4, 7, 5, 8, 3, 2, 6, 9)
    return x.reshape(b, grid_h * grid_w, 3 * temporal * p * p)


# ---------------------------------------------------------------------------
# Sampling
# ---------------------------------------------------------------------------

def sample_logits(generator: Optional[torch.Generator], logits: torch.Tensor,
                  temperature: float, top_p: float,
                  top_k_prefilter: int = 64) -> torch.Tensor:
    """(B, V) logits -> (B,) int64 token ids: argmax at temperature 0, else
    temperature + nucleus (top_p) sampling over a top-k prefilter (the
    vLLM-style keep set: a token stays while the probability of the tokens
    ranked above it is < top_p, so the top-1 always stays)."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits.float() / temperature
    if top_p >= 1.0:
        probs = torch.softmax(logits, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]
    k = min(top_k_prefilter, logits.shape[-1])
    top_vals, top_idx = torch.topk(logits, k, dim=-1)     # sorted desc
    probs = torch.softmax(top_vals, dim=-1)
    keep = probs.cumsum(dim=-1) - probs < top_p
    masked = torch.where(keep, top_vals, float("-inf"))
    choice = torch.multinomial(torch.softmax(masked, dim=-1), 1,
                               generator=generator)
    return torch.gather(top_idx, -1, choice)[:, 0]


@dataclasses.dataclass
class GenerationResult:
    """Mirror of the reference's vLLM output consumption. Hidden states are
    CPU torch.bfloat16 tensors, the dtype the reference's vLLM fork returns
    and its precompute shards store."""

    texts: List[str]
    prompt_token_ids: List[List[int]]
    output_token_ids: List[List[int]]
    prompt_hidden_states: List[torch.Tensor]   # (prompt_len, D) each, bf16
    hidden_states: List[torch.Tensor]          # (gen_len, D) each, bf16
    input_prompts: List[str]


class EmbedEngine:
    def __init__(self, cfg: Qwen2VLConfig, params: Dict[str, Any],
                 tokenizer=None, *, max_prompt_len: int = 1024,
                 max_tokens: int = 256, min_tokens: int = 1,
                 temperature: float = 0.6, top_p: float = 0.9,
                 ignore_eos: bool = False, eos_ids: Sequence[int] = (),
                 system_prompt: str = DEFAULT_SYSTEM,
                 min_pixels: int = 56 * 56, max_pixels: int = 12845056,
                 limit_images_per_prompt: Optional[int] = None,
                 max_num_seqs: int = 16, vision_batch: int = 32,
                 prefill_chunk: Optional[int] = None,
                 prompt_format: str = "qwen2_vl",
                 top_k_prefilter: int = 64,
                 preadmit_wave: int = 0,
                 eos_lag: int = 0,
                 sampler: str = "exact",
                 device="cpu"):
        """``params``: the JAX-layout tree {"vision": ..., "lm": ...} (numpy
        or torch leaves; fp, quantized and fused layouts as ``cfg`` says),
        loaded into the port's modules on ``device``."""
        if max_num_seqs > MAX_DENSE_SLOTS:
            raise _not_in_slice(f"max_num_seqs={max_num_seqs} (> "
                                f"{MAX_DENSE_SLOTS} slots needs the paged pool)")
        if prefill_chunk:
            raise _not_in_slice("chunked prefill (prefill_chunk)")
        if preadmit_wave:
            raise _not_in_slice("prefill-ahead (preadmit_wave > 0)")
        if eos_lag:
            raise _not_in_slice("pipelined EOS accounting (eos_lag > 0)")
        if sampler != "exact":
            raise _not_in_slice(f"sampler '{sampler}' (fused lm_head sampler)")
        self.cfg = cfg
        self.device = torch.device(device)
        self.tokenizer = tokenizer
        self.max_prompt_len = max_prompt_len
        self.max_tokens = max_tokens
        self.min_tokens = min_tokens
        self.temperature = temperature
        self.top_p = top_p
        self.top_k_prefilter = int(top_k_prefilter)
        self.ignore_eos = ignore_eos
        self.eos_ids = list(eos_ids)
        self.system_prompt = system_prompt
        self.min_pixels = min_pixels
        self.max_pixels = max_pixels
        self.limit_images_per_prompt = limit_images_per_prompt
        self.max_num_seqs = max_num_seqs
        self.vision_batch = max(1, int(vision_batch))
        self.prompt_format = prompt_format
        self.vision = load_params(
            Qwen2VisionTower(cfg.vision, self.device), params["vision"]).eval()
        self.lm = load_params(Qwen2VLModel(cfg, self.device), params["lm"]).eval()
        self._img_bank = None
        # seconds per phase of the last generate(), device work included
        self.last_phase_times: Dict[str, float] = {}
        self.num_system_tokens = self._count_system_tokens()

    # -- construction -------------------------------------------------------
    @classmethod
    def from_config(cls, model_cfg: Dict[str, Any], device="cpu") -> "EmbedEngine":
        """Build from a model config section (the precompute YAML's
        ``model``) with the checkpoint and tokenizer files on local disk."""
        from thinkdiff_torch.models.bridge import local_hf_state_dict
        from thinkdiff_torch.models.qwen2_vl import (
            convert_qwen2_vl, fuse_qwen2_params)
        from thinkdiff_torch.ops.quant import quantize_tree

        path = model_cfg.get("mllama_pretrained_model_name_or_path",
                             "Qwen/Qwen2-VL-2B-Instruct")
        dtype = {None: torch.float32, "float32": torch.float32,
                 "bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
                 "float16": torch.float16}[model_cfg.get("dtype", "bfloat16")]
        vcfg = model_cfg.get("vllm_config", {}) or {}
        modes = {"int8": True, "int8_dyn": "w8a8", "w8a8": "w8a8"}
        quant = modes.get(str(vcfg.get("quantization", "")).lower(), False)
        vquant = modes.get(str(vcfg.get("vision_quantization", "")).lower(),
                           False)
        fused = bool(vcfg.get("fused_proj", bool(quant)))
        factory = (Qwen2VLConfig.qwen2_vl_7b if "7B" in str(path)
                   else Qwen2VLConfig.qwen2_vl_2b)
        cfg = factory(dtype=dtype, quant_int8=quant, fused_proj=fused,
                      vision_quant=vquant)
        sd = local_hf_state_dict(path)
        if sd is None:
            raise FileNotFoundError(
                f"Qwen2-VL weights for '{path}' not found locally")
        params = convert_qwen2_vl(sd)
        if quant:
            params["lm"] = quantize_tree(params["lm"], min_size=0,
                                         w8a8=quant == "w8a8")
        if vquant:
            params["vision"] = quantize_tree(params["vision"], min_size=0,
                                             w8a8=vquant == "w8a8")
        if fused:
            params["lm"] = fuse_qwen2_params(params["lm"])
        from transformers import AutoTokenizer

        tokenizer = AutoTokenizer.from_pretrained(path, local_files_only=True)
        eos = [tokenizer.eos_token_id]
        im_end = tokenizer.convert_tokens_to_ids("<|im_end|>")
        if im_end is not None and im_end not in eos:
            eos.append(im_end)
        return cls(cfg, params, tokenizer, device=device,
                   eos_ids=eos, **engine_kwargs(model_cfg))

    # -- prompt building ----------------------------------------------------
    def _count_system_tokens(self) -> int:
        """Tokens before the user content (the reference's ``[14:]``): the
        whole system turn plus the user-turn header."""
        if self.tokenizer is None or self.prompt_format != "qwen2_vl":
            return 0
        text = (f"<|im_start|>system\n{self.system_prompt}<|im_end|>\n"
                f"<|im_start|>user\n")
        return len(self.tokenizer.encode(text, add_special_tokens=False))

    def tokenize_prompt(self, prompt: str,
                        image_token_counts: Sequence[int]) -> List[int]:
        """Tokenize a rendered prompt, expanding each <|image_pad|> to its
        image's token count."""
        ids = self.tokenizer.encode(prompt, add_special_tokens=False)
        pad_id = self.cfg.image_token_id
        out: List[int] = []
        img_i = 0
        for tid in ids:
            if tid == pad_id:
                out.extend([pad_id] * image_token_counts[img_i])
                img_i += 1
            else:
                out.append(tid)
        return out

    def build_prompt(self, text: str, n_images: int,
                     image_token_counts: Sequence[int]) -> Tuple[str, List[int]]:
        prompt = render_chat_prompt(self.system_prompt, text, n_images,
                                    fmt=self.prompt_format)
        return prompt, self.tokenize_prompt(prompt, image_token_counts)

    # -- device helpers -----------------------------------------------------
    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _tensor(self, a: np.ndarray, dtype=torch.long) -> torch.Tensor:
        return torch.as_tensor(a, dtype=dtype, device=self.device)

    # -- request preparation ------------------------------------------------
    def _prepare(self, texts, images_per_sample, raw: bool = False):
        """Vision passes (same-grid images batched) + prompts + M-RoPE
        positions. Returns (per-request dicts, image bank (rows, hidden) on
        the device, host/device phase seconds)."""
        ph = {"resize": 0.0, "vision": 0.0, "prompt": 0.0}
        t0 = time.perf_counter()
        b = len(texts)
        vcfg = self.cfg.vision
        merge = vcfg.spatial_merge_size
        all_pixels, all_grids = [], []
        per_sample_grids: List[List[Tuple[int, int, int]]] = []
        for img_entry in images_per_sample:
            if img_entry is None:
                imgs: Sequence[Any] = []
            elif isinstance(img_entry, (list, tuple)):
                imgs = img_entry
            else:
                imgs = [img_entry]
            if self.limit_images_per_prompt is not None:
                imgs = list(imgs)[: self.limit_images_per_prompt]
            grids = []
            for img in imgs:
                pixels, (h_bar, w_bar) = resize_image_uint8(
                    img, vcfg.patch_size * merge, self.min_pixels,
                    self.max_pixels)
                grid = (1, h_bar // vcfg.patch_size, w_bar // vcfg.patch_size)
                all_pixels.append(pixels)
                all_grids.append(grid)
                grids.append(grid)
            per_sample_grids.append(grids)
        if not images_per_sample:
            per_sample_grids = [[] for _ in range(b)]
        ph["resize"] = time.perf_counter() - t0
        t0 = time.perf_counter()

        # one vision call per distinct grid (chunks of vision_batch images)
        bank_start = np.zeros((len(all_pixels),), np.int64)
        bank_count = np.zeros((len(all_pixels),), np.int64)
        bank_parts: List[torch.Tensor] = []
        bank_off = 0
        groups: Dict[Tuple[int, int, int], List[int]] = {}
        for i, g in enumerate(all_grids):
            groups.setdefault(tuple(g), []).append(i)
        with torch.inference_mode():
            for grid, idxs in groups.items():
                pos_hw = vision_rot_pos_emb(np.asarray([grid], np.int64), merge)
                cos, sin = vision_cos_sin(pos_hw, vcfg.head_dim)
                cos = torch.as_tensor(cos, device=self.device)
                sin = torch.as_tensor(sin, device=self.device)
                for lo in range(0, len(idxs), self.vision_batch):
                    part = idxs[lo: lo + self.vision_batch]
                    pixels = torch.as_tensor(
                        np.stack([all_pixels[i] for i in part]),
                        device=self.device)
                    patches = patchify_normalize(
                        pixels, vcfg.patch_size, merge,
                        vcfg.temporal_patch_size).to(vcfg.dtype)
                    embeds = self.vision(patches, cos, sin, None)
                    s_m = embeds.shape[1]
                    bank_parts.append(embeds.reshape(-1, embeds.shape[-1]))
                    for j, i in enumerate(part):
                        bank_start[i] = bank_off + j * s_m
                        bank_count[i] = s_m
                    bank_off += len(part) * s_m
        if bank_parts:
            img_bank = torch.cat(bank_parts, dim=0)
        else:
            img_bank = torch.zeros((1, self.cfg.hidden_size),
                                   dtype=self.cfg.dtype, device=self.device)
        self._sync()
        ph["vision"] = time.perf_counter() - t0
        t0 = time.perf_counter()

        prepared = []
        img_i = 0
        for i in range(b):
            grids = per_sample_grids[i]
            counts = [t * h * w // (merge ** 2) for t, h, w in grids]
            if raw:
                prompt = texts[i]
                ids = self.tokenize_prompt(prompt, counts)
            else:
                prompt, ids = self.build_prompt(texts[i], len(grids), counts)
            pos, delta = get_mrope_position_ids(
                np.asarray(ids), np.asarray(grids, np.int64).reshape(-1, 3),
                self.cfg.image_token_id, merge)
            is_img = np.asarray(ids) == self.cfg.image_token_id
            img_bank_rows = img_local_idx = None
            if is_img.any():
                n_img = len(grids)
                img_bank_rows = np.concatenate([
                    np.arange(bank_start[g], bank_start[g] + bank_count[g])
                    for g in range(img_i, img_i + n_img)]).astype(np.int64)
                img_local_idx = np.nonzero(is_img)[0]
                img_i += n_img
            prepared.append(dict(prompt=prompt, ids=ids, pos=pos,
                                 delta=int(delta), img_bank_rows=img_bank_rows,
                                 img_local_idx=img_local_idx))
        ph["prompt"] = time.perf_counter() - t0
        return prepared, img_bank, ph

    def _pack_prompt_buffers(self, prepared, rows, pad_to):
        """Host-side padded buffers: (input_ids, mask, positions (3, rows,
        pad_to), img_gather (bank row per position), img_mask)."""
        input_ids = np.zeros((rows, pad_to), np.int64)
        mask = np.zeros((rows, pad_to), np.int64)
        positions = np.zeros((3, rows, pad_to), np.int64)
        img_gather = np.zeros((rows, pad_to), np.int64)
        img_mask = np.zeros((rows, pad_to), np.int64)
        for i, p in enumerate(prepared):
            L = len(p["ids"])
            input_ids[i, :L] = p["ids"]
            mask[i, :L] = 1
            positions[:, i, :L] = p["pos"]
            if p["img_bank_rows"] is not None:
                img_gather[i, p["img_local_idx"]] = p["img_bank_rows"]
                img_mask[i, p["img_local_idx"]] = 1
        return input_ids, mask, positions, img_gather, img_mask

    def _gather_img_embeds(self, img_gather: np.ndarray) -> torch.Tensor:
        """(rows, T) bank-row indices -> (rows, T, hidden) on the device;
        positions outside images read row 0 and are masked out."""
        return self._img_bank[self._tensor(img_gather)]

    # -- prefill and decode -------------------------------------------------
    def _sample_first(self, logits, generator):
        if (not self.ignore_eos) and self.min_tokens > 1 and self.eos_ids:
            logits = logits.float()
            logits[:, self.eos_ids] = float("-inf")
        return sample_logits(generator, logits, self.temperature, self.top_p,
                             self.top_k_prefilter)

    def _prefill(self, prepared, max_tokens, generator):
        """One-shot prefill of the padded batch (prompt length bucketed to a
        power of two >= 64) into fresh dense caches of pad_to + max_tokens
        positions. Returns (first tokens (m,), hidden bf16 (m, pad_to, D),
        caches, prompt_lens, last_idx, start_pos)."""
        cfg = self.cfg
        m = len(prepared)
        prompt_lens = [len(p["ids"]) for p in prepared]
        pad_to = min(1 << max(6, (max(prompt_lens) - 1).bit_length()),
                     self.max_prompt_len)
        if max(prompt_lens) > pad_to:
            raise ValueError(f"prompt of {max(prompt_lens)} tokens exceeds "
                             f"max_prompt_len={self.max_prompt_len}")
        input_ids, mask, positions, img_gather, img_mask = \
            self._pack_prompt_buffers(prepared, m, pad_to)
        shape = (m, cfg.num_kv_heads, pad_to + max_tokens, cfg.head_dim)
        caches = [(torch.zeros(shape, dtype=cfg.dtype, device=self.device),
                   torch.zeros(shape, dtype=cfg.dtype, device=self.device))
                  for _ in range(cfg.num_layers)]
        last_idx = np.asarray(prompt_lens) - 1
        _, hidden, caches = self.lm(
            input_ids=self._tensor(input_ids),
            position_ids=self._tensor(positions), mask=self._tensor(mask),
            image_embeds=self._gather_img_embeds(img_gather),
            image_mask=self._tensor(img_mask), caches=caches,
            compute_logits=False)
        last_hidden = hidden[torch.arange(m, device=self.device),
                             self._tensor(last_idx)]
        first = self._sample_first(self.lm.logits(last_hidden), generator)
        start_pos = np.asarray(
            [prompt_lens[i] + prepared[i]["delta"] for i in range(m)])
        return (first, hidden.to(torch.bfloat16), caches, prompt_lens,
                last_idx, start_pos)

    def _decode(self, caches, first, start_pos, prompt_lens, steps, generator):
        """``steps`` single-token decode steps over the dense caches (updated
        in place). Returns (tokens (B, steps), hidden bf16 (B, steps, D))."""
        eos = torch.zeros(self.cfg.vocab_size, dtype=torch.bool,
                          device=self.device)
        if self.eos_ids:
            eos[self.eos_ids] = True
        tokens = first
        cache_len = self._tensor(np.asarray(prompt_lens))
        pos = self._tensor(start_pos)
        out_tokens, out_hidden = [], []
        for i in range(steps):
            pos3 = pos[None, :, None].expand(3, pos.shape[0], 1)
            _, hidden, _ = self.lm(
                input_ids=tokens[:, None], position_ids=pos3, caches=caches,
                cache_len=cache_len, compute_logits=False)
            logits = self.lm.logits(hidden[:, 0])
            if not self.ignore_eos and i < self.min_tokens - 1:
                logits = logits.masked_fill(eos[None], float("-inf"))
            tokens = sample_logits(generator, logits, self.temperature,
                                   self.top_p, self.top_k_prefilter)
            out_tokens.append(tokens)
            out_hidden.append(hidden[:, 0].to(torch.bfloat16))
            cache_len = cache_len + 1
            pos = pos + 1
        return torch.stack(out_tokens, dim=1), torch.stack(out_hidden, dim=1)

    # -- generation ---------------------------------------------------------
    def generate(self, samples: Dict[str, Any],
                 max_new_tokens: Optional[int] = None,
                 seed: int = 0) -> GenerationResult:
        """samples: {"images": [PIL or [PIL, ...]], "answers": [str]} — or
        "prompts" / "raw_prompts". Static batch: one prefill, a decode loop
        to max_tokens, outputs cut after the first EOS."""
        images_per_sample = samples.get("images", [])
        raw = bool(samples.get("raw_prompts"))
        texts = (samples.get("raw_prompts") or samples.get("answers")
                 or samples.get("prompts"))
        b = len(texts)
        max_tokens = int(max_new_tokens or self.max_tokens)
        with torch.inference_mode():
            prepared, self._img_bank, phases = self._prepare(
                texts, images_per_sample, raw=raw)
            generator = torch.Generator(device=self.device).manual_seed(seed)
            t0 = time.perf_counter()
            first, hidden, caches, prompt_lens, last_idx, start_pos = \
                self._prefill(prepared, max_tokens, generator)
            self._sync()
            phases["prefill"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            # the hidden state of the step that PRODUCED each token: the
            # prefill's last position produced token 0, decode step i
            # produced token i + 1
            last = hidden[torch.arange(b, device=self.device),
                          self._tensor(last_idx)][:, None]
            gen_tokens, gen_hidden = first[:, None], last
            if max_tokens > 1:
                toks, hid = self._decode(caches, first, start_pos,
                                         prompt_lens, max_tokens - 1,
                                         generator)
                gen_tokens = torch.cat([gen_tokens, toks], dim=1)
                gen_hidden = torch.cat([gen_hidden, hid], dim=1)
            gen_tokens = gen_tokens.cpu()
            gen_hidden = gen_hidden.cpu()
            hidden = hidden.cpu()
            phases["decode"] = time.perf_counter() - t0
        self.last_phase_times = phases

        out_texts, out_ids, out_hidden, prompt_hidden = [], [], [], []
        for i in range(b):
            toks = gen_tokens[i].tolist()
            if not self.ignore_eos and self.eos_ids:
                for j, t in enumerate(toks):
                    if t in self.eos_ids and j >= self.min_tokens - 1:
                        toks = toks[: j + 1]
                        break
            n = len(toks)
            out_ids.append(toks)
            out_hidden.append(gen_hidden[i, :n])
            prompt_hidden.append(hidden[i, : prompt_lens[i]])
            out_texts.append(self.tokenizer.decode(
                [t for t in toks if t not in self.eos_ids],
                skip_special_tokens=True) if self.tokenizer else "")
        return GenerationResult(
            texts=out_texts,
            prompt_token_ids=[list(p["ids"]) for p in prepared],
            output_token_ids=out_ids, prompt_hidden_states=prompt_hidden,
            hidden_states=out_hidden,
            input_prompts=[p["prompt"] for p in prepared])

    def generate_many(self, samples: Dict[str, Any],
                      max_new_tokens: Optional[int] = None, seed: int = 0,
                      slots: Optional[int] = None, chunk: int = 32,
                      paged: Optional[bool] = None) -> GenerationResult:
        """The scheduler entry point. This port serves its static branch:
        when every request fits the slots (or nothing can finish early:
        ignore_eos, or max_tokens <= chunk) it is one ``generate``. The
        paged pool and the dense refill scheduler raise NotImplementedError."""
        texts = (samples.get("raw_prompts") or samples.get("answers")
                 or samples.get("prompts"))
        n = len(texts)
        max_tokens = int(max_new_tokens or self.max_tokens)
        slots = int(slots or min(n, self.max_num_seqs))
        if paged or slots > MAX_DENSE_SLOTS:
            raise _not_in_slice(f"paged KV serving ({slots} slots)")
        if n <= slots or max_tokens <= chunk or self.ignore_eos:
            return self.generate(samples, max_new_tokens=max_new_tokens,
                                 seed=seed)
        raise _not_in_slice(f"continuous batching of {n} requests over "
                            f"{slots} slots (dense refill)")


def engine_kwargs(model_cfg: Dict[str, Any]) -> Dict[str, Any]:
    """EmbedEngine keyword arguments from a model config's ``vllm_config``
    (the precompute YAML's names; vLLM's where they exist)."""
    vcfg = model_cfg.get("vllm_config", {}) or {}
    limit_mm = vcfg.get("limit_mm_per_prompt", None)
    if isinstance(limit_mm, dict):
        limit_mm = limit_mm.get("image")
    chunk = (int(vcfg.get("prefill_chunk") or 0)
             or (256 if bool(vcfg.get("enable_chunked_prefill", False))
                 else None) or None)
    return dict(
        max_prompt_len=min(int(vcfg.get("max_model_len", 8192)), 8192),
        max_tokens=int(vcfg.get("max_tokens", 256)),
        min_tokens=int(vcfg.get("min_tokens", 1)),
        temperature=float(vcfg.get("temperature", 0.6)),
        top_p=float(vcfg.get("top_p", 0.9)),
        ignore_eos=bool(vcfg.get("ignore_eos", False)),
        limit_images_per_prompt=limit_mm,
        max_num_seqs=int(vcfg.get("max_num_seqs", 16)),
        vision_batch=int(vcfg.get("vision_batch", 32)),
        top_k_prefilter=int(vcfg.get("top_k_prefilter", 64)),
        preadmit_wave=int(vcfg.get("preadmit_wave", 0)),
        eos_lag=int(vcfg.get("eos_lag", 0)),
        sampler=str(vcfg.get("sampler", "exact")),
        prefill_chunk=chunk,
        prompt_format=str(
            vcfg.get("prompt_format", "")
            or model_cfg.get("prompt_format", "")
            or prompt_format_for_model(model_cfg.get(
                "mllama_model_id",
                model_cfg.get("mllama_pretrained_model_name_or_path",
                              "Qwen/Qwen2-VL-2B-Instruct")))),
    )


class MllamaVllmGenerateModel:
    """Registry model wrapping the engine for the precompute task — the
    reference's ``mllama-vllm-generate-1``."""

    def __init__(self, cfg: Dict[str, Any], engine: Optional[EmbedEngine] = None):
        self.cfg = cfg
        self.engine = engine if engine is not None else EmbedEngine.from_config(cfg)
        vcfg = cfg.get("vllm_config", {}) or {}
        self.embedding_layer_name = vcfg.get("embedding_layer_name", "model.norm")
        self.text_input_key = cfg.get("text_input_key", None) or "answers"
        model_id = str(cfg.get("mllama_model_id",
                               cfg.get("mllama_pretrained_model_name_or_path",
                                       "")))
        self._strip_leading_space = any(
            name in model_id for name in _LLAVA_LEADING_SPACE_IDS)
        self.max_num_seqs = int(vcfg.get("max_num_seqs", 32))

    @classmethod
    def from_config(cls, cfg):
        return cls(cfg)

    def load_checkpoint_from_config(self, cfg):
        pass  # frozen inference model

    def forward(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        """Host batch (any size) -> image-size-sorted groups of
        4 * max_num_seqs requests -> merged results in the original order."""
        texts = batch[self.text_input_key]
        n = len(texts)
        images = batch.get("images", [None] * n)
        vcfg = self.engine.cfg.vision
        factor = vcfg.patch_size * vcfg.spatial_merge_size

        def est_tokens(i):
            # the sort key of the JAX engine, 28-pixel merged patches
            img = images[i]
            total = 0
            for im in (img if isinstance(img, (list, tuple)) else [img]):
                if im is None:
                    continue
                w, h = getattr(im, "size", (448, 448))
                hb, wb = smart_resize(h, w, factor, self.engine.min_pixels,
                                      self.engine.max_pixels)
                total += (hb // 28) * (wb // 28)
            return total

        order = sorted(range(n), key=est_tokens)
        out: Dict[int, Any] = {}
        group = self.max_num_seqs * 4
        for start in range(0, n, group):
            idxs = order[start: start + group]
            sub = {"images": [images[i] for i in idxs],
                   "answers": [texts[i] for i in idxs]}
            result = self.engine.generate_many(
                sub, seed=start, slots=self.max_num_seqs)
            for j, i in enumerate(idxs):
                out[i] = (
                    result.texts[j], result.input_prompts[j],
                    result.prompt_token_ids[j], result.output_token_ids[j],
                    result.prompt_hidden_states[j], result.hidden_states[j],
                )
        cols = list(zip(*[out[i] for i in range(n)]))
        gen_texts = list(cols[0])
        if self._strip_leading_space:
            gen_texts = [t.replace(" ", "", 1) if t[:1] == " " else t
                         for t in gen_texts]
        return {
            "generated_texts": gen_texts,
            "input_prompts": list(cols[1]),
            "prompt_token_ids": list(cols[2]),
            "output_token_ids": list(cols[3]),
            "prompt_hidden_states": list(cols[4]),
            "hidden_states": list(cols[5]),
            "embedding_layer_name": self.embedding_layer_name,
        }


registry.register_model("mllama-vllm-generate-1")(MllamaVllmGenerateModel)
