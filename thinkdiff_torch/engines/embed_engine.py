"""Qwen2-VL embedding engine in PyTorch (counterpart of
thinkdiff_tpu/engines/embed_engine.py): images + prompts in, generated text
and per-token ``model.norm`` hidden states out — the role the reference's
forked vLLM plays (``LLM(..., return_hidden_states=True)``).

Pipeline per batch:
  host:   smart-resize (PIL, uint8 out), chat-template tokenize, M-RoPE
          position ids
  device: normalize + patchify -> vision tower (flash kernel, weight-only
          or w8a8 projections) -> prefill into a KV cache: one-shot
          (flash kernel) or in fixed chunks of ``prefill_chunk`` tokens
          (plain cache attention) -> decode with temperature/top-p sampling
          or the fused lm_head + Gumbel kernel -> bf16 hidden states of
          prompt and generated tokens.

Schedulers (``generate_many``): the static batch (``generate``: every
request admitted at once), the dense refill scheduler (a slot whose request
finished takes the next one at a chunk boundary), and the paged scheduler
(the KV pool in pages with the paged decode kernel, prefill-ahead waves,
pipelined EOS accounting). The entry points run on the CUDA card unless the
caller passes ``device="cpu"``; without a card they raise.

On a mesh (``mesh=``, the counterpart of JAX's argument: one process a
device, over ``torch.distributed``, parallel/mesh.py's layout) every rank
gets the same call with the global requests, and data coordinate d serves
its block of them (requests [d n / D, (d + 1) n / D)); the ``fsdp`` and
``model`` peers of a coordinate serve the same requests in lockstep, each
holding its share of the weights (JAX's rules, parallel/sharding.py) and of
the KV caches and pages (its Hkv/M kv heads). A peer's scheduler decides
from the tokens alone, and every sampled token is one value on every peer:
greedy ids are the global argmax over the ranks' vocabulary columns
(``vocab_split_argmax``); the exact sampler gathers the logits over
``model`` in the model dtype and samples the whole vector with the same
generator on every peer; the Gumbel sampler runs the fused kernel on the
rank's vocabulary shard and reduces the rows' argmax keys with one MAX
over the group. The ``GenerationResult`` is gathered over ``data`` as host
objects, so every rank returns the whole result in request order, as
JAX's single program does. A data coordinate's streams are those of the
unsharded engine on its block with the same seed.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from thinkdiff_torch import registry, resolve_device
from thinkdiff_torch.core.config import model_default_config_path
from thinkdiff_torch.models.bridge import fill_, load_params, tree_draw
from thinkdiff_torch.models.qwen2_vl import (
    Qwen2VLConfig, Qwen2VLModel, Qwen2VisionTower, get_mrope_position_ids,
    vision_cos_sin, vision_rot_pos_emb,
)
from thinkdiff_torch.ops.chunked_ce import vocab_split_argmax
from thinkdiff_torch.ops.fused_sample import (
    fused_lm_sample, keys_to_ids, pack_lm_head, pack_tied_embedding)
from thinkdiff_torch.ops.paged_attention import commit_pages
from thinkdiff_torch.parallel import collectives as col

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)

DEFAULT_SYSTEM = "You are a helpful assistant."


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


class _HostCopy:
    """A device->host copy started now and read later. On the card the
    tensor is copied into fresh pinned memory behind the work already
    queued, and ``resolve`` waits on that copy's event only; a CPU tensor
    is kept as it is. The source must not be overwritten afterwards: the
    schedulers hand it freshly made tensors only."""

    __slots__ = ("_host", "_event")

    def __init__(self, t: torch.Tensor):
        self._event = None
        if t.is_cuda:
            self._host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._host.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = t

    def resolve(self) -> torch.Tensor:
        if self._event is not None:
            self._event.synchronize()
            self._event = None
        return self._host


class _HostHidden:
    """Lazy host view of hidden-state parts (concatenated along ``axis``):
    the copies start at construction and stream behind later device work;
    rows are read at result assembly."""

    __slots__ = ("parts", "axis", "_arr")

    def __init__(self, parts: Sequence[torch.Tensor], axis: int = 1):
        self.parts = [_HostCopy(p) for p in parts]
        self.axis = axis
        self._arr = None

    def resolve(self) -> torch.Tensor:
        if self._arr is None:
            ps = [p.resolve() for p in self.parts]
            self._arr = ps[0] if len(ps) == 1 else torch.cat(ps, self.axis)
            self.parts = None
        return self._arr


def _tokcell(cell: Dict[str, Any]) -> np.ndarray:
    """A lazily copied token tensor as numpy, resolved once."""
    if cell["arr"] is None:
        cell["arr"] = cell["host"].resolve().numpy()
        cell["dev"] = cell["host"] = None
    return cell["arr"]


def _token_cell(t: torch.Tensor) -> Dict[str, Any]:
    return {"dev": t, "host": _HostCopy(t), "arr": None}


class EmbedEngine:
    def __init__(self, cfg: Qwen2VLConfig, params: Dict[str, Any],
                 tokenizer=None, *, max_prompt_len: int = 1024,
                 max_tokens: int = 256, min_tokens: int = 1,
                 temperature: float = 0.6, top_p: float = 0.9,
                 ignore_eos: bool = False, eos_ids: Sequence[int] = (),
                 system_prompt: str = DEFAULT_SYSTEM,
                 min_pixels: int = 56 * 56, max_pixels: int = 12845056,
                 limit_images_per_prompt: Optional[int] = None,
                 max_num_seqs: int = 16, kv_page_size: int = 64,
                 vision_batch: int = 32,
                 prefill_chunk: Optional[int] = None,
                 prompt_format: str = "qwen2_vl",
                 top_k_prefilter: int = 64,
                 preadmit_wave: int = 0,
                 eos_lag: int = 0,
                 sampler: str = "exact",
                 mesh=None,
                 device="cuda"):
        """``params``: the JAX-layout tree {"vision": ..., "lm": ...} (numpy
        or torch leaves; fp, quantized and fused layouts as ``cfg`` says),
        loaded into the port's modules on ``device``: the CUDA card unless
        the caller asks for the CPU. Either entry may instead be a draw of
        ``parallel.sharding.build_sharded`` (e.g. ``qwen2_vl.init_draw``'s
        seeded one), which fills the module one submodule at a time.

        ``mesh`` (parallel/mesh.py, its size the world's): made the run's
        mesh (``set_mesh``, which refuses another size), the vision tower
        and the LM built block by block with this rank's blocks only, and
        the requests split over ``data`` (the module docstring).

        Serving knobs, as in the JAX engine: ``prefill_chunk`` (a power of
        two >= 64) prefills prompts in fixed chunks against the cache;
        ``preadmit_wave`` (paged only) prefills up to that many queued
        requests into spare pages ahead of their slots; ``eos_lag`` (paged)
        reads chunk c's tokens only after chunk c + eos_lag is dispatched;
        ``sampler='gumbel'`` samples with the fused lm_head + Gumbel kernel
        (w8a8 language model only; otherwise the exact sampler serves)."""
        self.device = resolve_device(device)
        if prefill_chunk is not None:
            prefill_chunk = int(prefill_chunk)
            if prefill_chunk < 64 or prefill_chunk & (prefill_chunk - 1):
                raise ValueError("prefill_chunk must be a power of two >= 64")
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.max_prompt_len = max_prompt_len
        self.max_tokens = max_tokens
        self.min_tokens = min_tokens
        self.temperature = temperature
        self.top_p = top_p
        self.top_k_prefilter = int(top_k_prefilter)
        self.sampler = str(sampler)
        self.ignore_eos = ignore_eos
        self.eos_ids = list(eos_ids)
        self.system_prompt = system_prompt
        self.min_pixels = min_pixels
        self.max_pixels = max_pixels
        self.limit_images_per_prompt = limit_images_per_prompt
        self.max_num_seqs = max_num_seqs
        self.kv_page_size = kv_page_size
        self.vision_batch = max(1, int(vision_batch))
        self.prefill_chunk = prefill_chunk
        self.preadmit_wave = int(preadmit_wave or 0)
        self.eos_lag = int(eos_lag or 0)
        self.prompt_format = prompt_format
        # scheduler hooks (the JAX engine's attributes): lazy_tokens=False
        # forces synchronous token accounting; stop_len_fn(req, n_generated)
        # is a count-only stop rule, stop_fn(req, tokens) reads values
        self.lazy_tokens = True
        self.stop_len_fn: Optional[Callable[[int, int], bool]] = None
        self.stop_fn: Optional[Callable[[int, List[int]], bool]] = None
        self.mesh = mesh
        if mesh is not None:
            from thinkdiff_torch.parallel.mesh import set_mesh

            set_mesh(mesh)
        self.vision = self._build(Qwen2VisionTower, cfg.vision,
                                  params["vision"])
        self.lm = self._build(Qwen2VLModel, cfg, params["lm"])
        self._img_bank = None
        self._lm_pack = None
        self._lm_pack_key = None
        self._lm_pack_col0 = None
        self._eos_cache = None
        # seconds per phase of the last generate(), device work included
        self.last_phase_times: Dict[str, float] = {}
        # wall-time breakdown of the last generate_many() (JAX's key names)
        self.last_phase_stats: Dict[str, float] = {}
        # bytes of the KV caches or pages the last generate_many() held
        self.last_kv_bytes = 0
        self.num_system_tokens = self._count_system_tokens()

    # -- construction -------------------------------------------------------
    def _build(self, cls, cfg, params):
        """``cls(cfg)`` with ``params`` (a tree or a draw): on a sharded
        mesh built on ``meta`` and materialized block by block, this rank
        keeping its blocks (no rank holds the whole tower), else whole."""
        draw = params if callable(params) else None
        if self.mesh is not None and self.mesh.sharded:
            from thinkdiff_torch.core.distributed import get_rank
            from thinkdiff_torch.parallel.sharding import build_sharded

            return build_sharded(
                cls(cfg, device="meta"), self.mesh,
                self.mesh.coords(get_rank()), self.device,
                draw or tree_draw(params)).eval()
        if draw is not None:
            return fill_(cls(cfg, self.device), draw).eval()
        return load_params(cls(cfg, self.device), params).eval()

    @classmethod
    def from_config(cls, model_cfg: Dict[str, Any], device="cuda") -> "EmbedEngine":
        """Build from a model config section (the precompute YAML's
        ``model``) with the checkpoint and tokenizer files on local disk."""
        from thinkdiff_torch.models.bridge import local_hf_state_dict
        from thinkdiff_torch.models.qwen2_vl import (
            convert_qwen2_vl, fuse_qwen2_params)
        from thinkdiff_torch.ops.quant import quantize_tree

        device = resolve_device(device)
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

    def _tensor(self, a, dtype=torch.long) -> torch.Tensor:
        """Host array -> device tensor. On the card the upload goes through
        pinned memory without blocking the host on the device's queue."""
        t = torch.as_tensor(np.asarray(a), dtype=dtype)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _eos_mask(self, local: bool = False) -> torch.Tensor:
        """(V,) bool: the EOS token columns, made once per EOS set; with
        ``local`` the rank's vocabulary columns of it."""
        key = tuple(self.eos_ids)
        if self._eos_cache is None or self._eos_cache[0] != key:
            eos = np.zeros(self.cfg.vocab_size, bool)
            eos[list(key)] = True
            self._eos_cache = (key, self._tensor(eos, torch.bool))
        mask = self._eos_cache[1]
        if local:
            n = mask.shape[0] // col.model_size()
            mask = mask.narrow(0, col.model_index() * n, n)
        return mask

    def _split_greedy(self) -> bool:
        """Greedy sampling over the ranks' vocabulary columns: the logits
        stay local and the argmax is the group's."""
        return self.temperature == 0.0 and self.lm.vocab_split()

    def _logits(self, hidden) -> torch.Tensor:
        """The logits the samplers read: the rank's vocabulary columns for
        split greedy sampling, else every column (gathered over ``model``
        in the model dtype on a vocabulary-split mesh)."""
        return self.lm.logits(hidden, local=self._split_greedy())

    def _pick(self, generator, logits) -> torch.Tensor:
        if self._split_greedy():
            return vocab_split_argmax(logits)
        return sample_logits(generator, logits, self.temperature, self.top_p,
                             self.top_k_prefilter)

    def _seed2(self, generator: torch.Generator) -> torch.Tensor:
        """A (2,) int32 device seed for the fused sampler's noise, drawn
        from the engine's generator on the device (no host sync)."""
        return torch.randint(0, 2 ** 31 - 1, (2,), generator=generator,
                             device=self.device, dtype=torch.int32)

    def _new_caches(self, rows: int, size: int) -> List[Tuple[torch.Tensor,
                                                               torch.Tensor]]:
        """Dense (k, v) caches of every layer for the rank's kv heads."""
        shape = (rows, self.lm.local_kv_heads(), size, self.cfg.head_dim)
        return [(torch.zeros(shape, dtype=self.cfg.dtype, device=self.device),
                 torch.zeros(shape, dtype=self.cfg.dtype, device=self.device))
                for _ in range(self.cfg.num_layers)]

    # -- request preparation ------------------------------------------------
    def _prepare(self, texts, images_per_sample, raw: bool = False):
        """Vision passes (same-grid images batched) + prompts + M-RoPE
        positions. Returns (per-request dicts, image bank (rows, hidden) on
        the device, host/device phase seconds)."""
        ph = {"resize": 0.0, "vision_pack": 0.0, "vision": 0.0, "prompt": 0.0}
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
                cos = self._tensor(cos, torch.float32)
                sin = self._tensor(sin, torch.float32)
                for lo in range(0, len(idxs), self.vision_batch):
                    part = idxs[lo: lo + self.vision_batch]
                    tp = time.perf_counter()
                    batch_pixels = np.stack([all_pixels[i] for i in part])
                    ph["vision_pack"] += time.perf_counter() - tp
                    pixels = self._tensor(batch_pixels, torch.uint8)
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
        ph["vision"] = time.perf_counter() - t0 - ph["vision_pack"]
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

    def prepare_requests(self, samples: Dict[str, Any], raw: bool = None):
        """Streaming admission: a request batch's host and device inputs
        (resize, vision tower, prompts, M-RoPE), without touching serving
        state, so it can run in a worker thread while another batch
        decodes. Pass the result to ``generate_many(..., preprepared=...)``;
        greedy streams are those of the synchronous path. On a mesh it
        prepares the rank's data block, and runs the sharded vision tower's
        collectives: it must not overlap a decode on the same groups."""
        samples = self._data_block(samples)
        images_per_sample = samples.get("images", [])
        if raw is None:
            raw = bool(samples.get("raw_prompts"))
        texts = (samples.get("raw_prompts") or samples.get("answers")
                 or samples.get("prompts"))
        prepared, img_bank, phases = self._prepare(
            texts, images_per_sample, raw=raw)
        return {"prepared": prepared, "img_bank": img_bank,
                "phases": phases, "texts": texts}

    def _pack_prompt_buffers(self, prepared, rows, pad_to):
        """Host-side padded buffers: (input_ids, mask, positions (3, rows,
        pad_to), img_gather (bank row per position), img_mask); rows past
        len(prepared) stay zero."""
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

    # -- samplers -----------------------------------------------------------
    def _sample_first(self, logits, generator):
        if (not self.ignore_eos) and self.min_tokens > 1 and self.eos_ids:
            logits = logits.float().masked_fill(
                self._eos_mask(self._split_greedy())[None], float("-inf"))
        return self._pick(generator, logits)

    def _fused_sampler_pack(self):
        """The fused sampler's lm_head pack, or None when the exact sampler
        serves (sampler 'exact', or a language model that is not w8a8).
        Built once per EOS set: the pack bakes the EOS columns in. On a
        vocabulary-split mesh it is the pack of the rank's columns (its
        ``fsdp`` block gathered, its EOS columns made local), whose first
        global column ``_lm_pack_col0`` holds."""
        if self.sampler != "gumbel" or self.cfg.quant_int8 != "w8a8":
            return None
        eos = tuple(self.eos_ids) if not self.ignore_eos else ()
        if self._lm_pack is not None and self._lm_pack_key == eos:
            return self._lm_pack
        split = self.lm.vocab_split()
        head = getattr(self.lm, "lm_head", None)
        with torch.inference_mode():
            if head is not None:
                head = head.fsdp_gathered()
                vocab = head.kernel_q.shape[1]
            else:
                table = self.lm.embed_tokens._table()[0]
                vocab = table.shape[0]
            col0 = col.model_index() * vocab if split else None
            lo = col0 or 0
            local_eos = [e - lo for e in eos if lo <= e < lo + vocab]
            if head is not None:
                pack = pack_lm_head(head.kernel_q, head.kernel_scale,
                                    input_scale=head.input_scale,
                                    eos_ids=local_eos)
            else:
                pack = pack_tied_embedding(table, local_eos)
        self._lm_pack, self._lm_pack_key = pack, eos
        self._lm_pack_col0 = col0
        return pack

    def _fused_sample(self, h, pack, blocked, generator) -> torch.Tensor:
        """The fused sampler's tokens: on a vocabulary shard, the rows'
        argmax keys reduced with one MAX over the model group."""
        seed2 = self._seed2(generator)
        kw = dict(temperature=self.temperature, noise=self.temperature > 0)
        if self._lm_pack_col0 is None:
            return fused_lm_sample(h, pack, blocked, seed2, **kw)
        keys = fused_lm_sample(h, pack, blocked, seed2,
                               col0=self._lm_pack_col0, keys=True, **kw)
        return keys_to_ids(col.model_all_reduce(keys, "max"))

    def _first_tokens(self, last_hidden, generator):
        """First tokens from the last prompt hidden states (the chunked
        prefill's tail): the fused sampler when its pack exists, so every
        sampled token of a stream draws from one family; else logits + the
        exact first-token sampler."""
        pack = self._fused_sampler_pack()
        if pack is not None:
            b = last_hidden.shape[0]
            block = float((not self.ignore_eos) and self.min_tokens > 1)
            blocked = torch.full((b,), block, dtype=torch.float32,
                                 device=self.device)
            return self._fused_sample(last_hidden.to(self.cfg.dtype), pack,
                                      blocked, generator)
        return self._sample_first(
            self._logits(last_hidden.to(self.cfg.dtype)), generator)

    # -- prefill ------------------------------------------------------------
    def _prefill(self, prepared, max_tokens, generator, cache_size=None):
        """Padded-buffer prefill of a request list into fresh dense caches
        of ``cache_size`` positions (default pad + max_tokens). Returns
        (first tokens (m,), hidden bf16 (>= m rows, pad, D) on the device,
        caches (m rows), prompt_lens, last_idx, start_pos)."""
        if self.prefill_chunk:
            return self._prefill_chunked(prepared, max_tokens, generator,
                                         cache_size)
        m = len(prepared)
        prompt_lens = [len(p["ids"]) for p in prepared]
        pad_to = min(1 << max(6, (max(prompt_lens) - 1).bit_length()),
                     self.max_prompt_len)
        if max(prompt_lens) > pad_to:
            raise ValueError(f"prompt of {max(prompt_lens)} tokens exceeds "
                             f"max_prompt_len={self.max_prompt_len}")
        input_ids, mask, positions, img_gather, img_mask = \
            self._pack_prompt_buffers(prepared, m, pad_to)
        caches = self._new_caches(m, cache_size or (pad_to + max_tokens))
        last_idx = np.asarray(prompt_lens) - 1
        _, hidden, caches = self.lm(
            input_ids=self._tensor(input_ids),
            position_ids=self._tensor(positions), mask=self._tensor(mask),
            image_embeds=self._img_bank[self._tensor(img_gather)],
            image_mask=self._tensor(img_mask), caches=caches,
            compute_logits=False)
        last_hidden = hidden[torch.arange(m, device=self.device),
                             self._tensor(last_idx)]
        first = self._sample_first(self._logits(last_hidden), generator)
        start_pos = np.asarray(
            [prompt_lens[i] + prepared[i]["delta"] for i in range(m)])
        return (first, hidden.to(torch.bfloat16), caches, prompt_lens,
                last_idx, start_pos)

    def _prefill_chunked(self, prepared, max_tokens, generator,
                         cache_size=None):
        """Chunked prefill, the contract of ``_prefill``: the prompts run in
        fixed (m_pad, C) chunks against the caches (write offset k*C, plain
        cache attention; query i of chunk k attends positions < kC + i + 1)
        instead of one bucketed pass. Rows are padded to a power of two
        (m_pad), the chunk grid is clamped to the prompt bucket (the last
        chunk narrows), and each row's last-prompt-token hidden state is
        gathered on the device as its chunk passes (no host round trip
        before first-token sampling). Rows whose prompt ended write garbage
        KV past their length, which only their own garbage queries read.
        With temperature > 0 the first tokens are drawn over m_pad rows, so
        sampled streams differ from the one-shot path; greedy ones do not."""
        m = len(prepared)
        m_pad = 1 << max(0, (m - 1).bit_length())
        prompt_lens = [len(p["ids"]) for p in prepared]
        bucket = min(1 << max(6, (max(prompt_lens) - 1).bit_length()),
                     self.max_prompt_len)
        if max(prompt_lens) > bucket:
            raise ValueError(f"prompt of {max(prompt_lens)} tokens exceeds "
                             f"max_prompt_len={self.max_prompt_len}")
        cache_size = cache_size or (bucket + max_tokens)
        c = min(self.prefill_chunk, bucket)
        n_chunks = -(-max(prompt_lens) // c)
        pad_to = min(n_chunks * c, bucket)
        input_ids, _, positions, img_gather, img_mask = \
            self._pack_prompt_buffers(prepared, m_pad, pad_to)
        input_ids, positions = self._tensor(input_ids), self._tensor(positions)
        img_gather, img_mask = self._tensor(img_gather), self._tensor(img_mask)
        caches = self._new_caches(m_pad, cache_size)
        last_idx = np.asarray(prompt_lens) - 1
        last_idx_dev = self._tensor(np.concatenate(
            [last_idx, np.zeros(m_pad - m, np.int64)]))
        last_acc = torch.zeros((m_pad, self.cfg.hidden_size),
                               dtype=self.cfg.dtype, device=self.device)
        rows = torch.arange(m_pad, device=self.device)
        hid_chunks = []
        for k in range(n_chunks):
            lo, hi = k * c, min((k + 1) * c, pad_to)
            window = min(-(-hi // 256) * 256, cache_size)
            base = torch.full((m_pad,), lo, dtype=torch.long,
                              device=self.device)
            _, hidden_k, _ = self.lm(
                input_ids=input_ids[:, lo:hi],
                position_ids=positions[:, :, lo:hi],
                image_embeds=self._img_bank[img_gather[:, lo:hi]],
                image_mask=img_mask[:, lo:hi], caches=caches, cache_len=base,
                attn_window=window, compute_logits=False)
            rel = last_idx_dev - lo
            picked = hidden_k[rows, torch.clamp(rel, 0, hi - lo - 1)]
            last_acc = torch.where(((rel >= 0) & (rel < hi - lo))[:, None],
                                   picked.to(last_acc.dtype), last_acc)
            hid_chunks.append(hidden_k.to(torch.bfloat16))
        first = self._first_tokens(last_acc, generator)[:m]
        if m_pad != m:
            caches = [(kc[:m], vc[:m]) for kc, vc in caches]
        hidden = hid_chunks[0] if n_chunks == 1 else torch.cat(hid_chunks, 1)
        start_pos = np.asarray(
            [prompt_lens[i] + prepared[i]["delta"] for i in range(m)])
        return first, hidden, caches, prompt_lens, last_idx, start_pos

    # -- decode -------------------------------------------------------------
    def _decode_step(self, caches, tokens, cache_len, pos, blocked, generator,
                     page_table=None, attn_window=None, pack=None):
        """One single-token step for every slot: the cache (dense, or the
        page pools with ``page_table``) is written at cache_len in place.
        ``blocked`` (B,) bool marks rows whose EOS is still forbidden (None:
        never). Returns (next tokens (B,), hidden bf16 (B, D))."""
        pos3 = pos[None, :, None].expand(3, pos.shape[0], 1)
        _, hidden, _ = self.lm(
            input_ids=tokens[:, None], position_ids=pos3, caches=caches,
            cache_len=cache_len, compute_logits=False,
            attn_window=attn_window, page_table=page_table)
        h = hidden[:, 0]
        if pack is not None:
            blk = (torch.zeros(h.shape[0], dtype=torch.float32,
                               device=self.device) if blocked is None
                   else blocked.float())
            nxt = self._fused_sample(h, pack, blk, generator)
        else:
            logits = self._logits(h)
            if blocked is not None:
                eos = self._eos_mask(self._split_greedy())
                logits = torch.where(blocked[:, None] & eos[None],
                                     float("-inf"), logits.float())
            nxt = self._pick(generator, logits)
        return nxt, h.to(torch.bfloat16)

    def _chunk_decode(self, caches, tokens, cache_len, pos, gen_count, steps,
                      generator, page_table=None, attn_window=None, pack=None):
        """``steps`` decode steps over the caches (updated in place); a row's
        EOS is blocked while its ``gen_count`` < min_tokens - 1 (the refill
        schedulers count the first token; the static batch starts at 0, as
        its JAX step index does). Returns the advanced state (tokens,
        cache_len, pos, gen_count) and the chunk's fresh (S, steps) tokens
        and (S, steps, D) bf16 hidden states."""
        out_tokens, out_hidden = [], []
        for _ in range(steps):
            blocked = (None if self.ignore_eos
                       else gen_count < self.min_tokens - 1)
            tokens, h = self._decode_step(caches, tokens, cache_len, pos,
                                          blocked, generator, page_table,
                                          attn_window, pack)
            out_tokens.append(tokens)
            out_hidden.append(h)
            cache_len, pos, gen_count = cache_len + 1, pos + 1, gen_count + 1
        return (tokens, cache_len, pos, gen_count,
                torch.stack(out_tokens, dim=1), torch.stack(out_hidden, dim=1))

    # -- generation ---------------------------------------------------------
    def _cut_at_eos(self, toks: List[int]) -> int:
        if not self.ignore_eos and self.eos_ids:
            for j, t in enumerate(toks):
                if t in self.eos_ids and j >= self.min_tokens - 1:
                    return j + 1
        return len(toks)

    def _detok(self, toks: List[int]) -> str:
        if self.tokenizer is None:
            return ""
        return self.tokenizer.decode([t for t in toks if t not in self.eos_ids],
                                     skip_special_tokens=True)

    # -- the data axis ------------------------------------------------------
    def _data_split(self) -> bool:
        return self.mesh is not None and self.mesh.data > 1

    def _data_block(self, samples: Dict[str, Any]) -> Dict[str, Any]:
        """This rank's data coordinate's block of the requests (every
        request without a data axis)."""
        if not self._data_split():
            return samples
        from thinkdiff_torch.parallel.mesh import DATA_AXIS, axis_index

        texts = (samples.get("raw_prompts") or samples.get("answers")
                 or samples.get("prompts"))
        n, d = len(texts), self.mesh.data
        if n < d:
            raise ValueError(f"{n} requests over {d} data coordinates: each "
                             f"serves a block of at least one")
        lo = axis_index(DATA_AXIS) * n // d
        hi = (axis_index(DATA_AXIS) + 1) * n // d
        return {k: (v[lo:hi] if isinstance(v, (list, tuple)) and len(v) == n
                    else v) for k, v in samples.items()}

    def _over_data(self, fn, samples, **kw) -> GenerationResult:
        """``fn`` on this rank's block of ``samples``, the blocks' results
        gathered over ``data`` and joined in request order."""
        if not self._data_split():
            return fn(samples, **kw)
        parts = col.data_gather_objects(fn(self._data_block(samples), **kw))
        return GenerationResult(*[
            [x for part in parts for x in getattr(part, f.name)]
            for f in dataclasses.fields(GenerationResult)])

    def generate(self, samples: Dict[str, Any],
                 max_new_tokens: Optional[int] = None,
                 seed: int = 0) -> GenerationResult:
        """samples: {"images": [PIL or [PIL, ...]], "answers": [str]} — or
        "prompts" / "raw_prompts". Static batch: one prefill, a decode loop
        to max_tokens, outputs cut after the first EOS. On a mesh the whole
        result on every rank (the module docstring)."""
        return self._over_data(self._generate, samples,
                               max_new_tokens=max_new_tokens, seed=seed)

    def _generate(self, samples: Dict[str, Any],
                  max_new_tokens: Optional[int] = None,
                  seed: int = 0) -> GenerationResult:
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
                *_, toks, hid = self._chunk_decode(
                    caches, first, self._tensor(prompt_lens),
                    self._tensor(start_pos), torch.zeros_like(first),
                    max_tokens - 1, generator)
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
            toks = toks[: self._cut_at_eos(toks)]
            out_ids.append(toks)
            out_hidden.append(gen_hidden[i, :len(toks)])
            prompt_hidden.append(hidden[i, : prompt_lens[i]])
            out_texts.append(self._detok(toks))
        return GenerationResult(
            texts=out_texts,
            prompt_token_ids=[list(p["ids"]) for p in prepared],
            output_token_ids=out_ids, prompt_hidden_states=prompt_hidden,
            hidden_states=out_hidden,
            input_prompts=[p["prompt"] for p in prepared])

    @staticmethod
    def _page_rows(table_np, slot_ids, prompt_lens, pad_to, page):
        """Destination page ids for commit_pages: (m * pad_to // page,);
        page-rows past a prompt's page count go to the trash page 0."""
        rows = []
        for j, si in enumerate(slot_ids):
            npg = -(-prompt_lens[j] // page)
            for k in range(pad_to // page):
                rows.append(int(table_np[si, k]) if k < npg else 0)
        return np.asarray(rows, np.int64)

    def generate_many(self, samples: Dict[str, Any],
                      max_new_tokens: Optional[int] = None, seed: int = 0,
                      slots: Optional[int] = None, chunk: int = 32,
                      paged: Optional[bool] = None, refill_batch: int = 0,
                      preprepared: Optional[Dict[str, Any]] = None
                      ) -> GenerationResult:
        """The continuous-batching scheduler (``_generate_many``); on a
        mesh the whole result on every rank (the module docstring), each
        data coordinate scheduling its block (``preprepared`` is then
        ``prepare_requests``' of the same samples: the rank's block)."""
        return self._over_data(
            self._generate_many, samples, max_new_tokens=max_new_tokens,
            seed=seed, slots=slots, chunk=chunk, paged=paged,
            refill_batch=refill_batch, preprepared=preprepared)

    @torch.inference_mode()
    def _generate_many(self, samples: Dict[str, Any],
                       max_new_tokens: Optional[int] = None, seed: int = 0,
                       slots: Optional[int] = None, chunk: int = 32,
                       paged: Optional[bool] = None, refill_batch: int = 0,
                       preprepared: Optional[Dict[str, Any]] = None
                       ) -> GenerationResult:
        """Continuous batching over any number of requests (the scheduler
        role vLLM plays for the reference): ``slots`` decode lanes; a slot
        whose request finished takes the next queued one at a ``chunk``-step
        boundary. Dense (``paged=False``): per-slot caches of prompt bucket
        + max_tokens + chunk positions, attention windows grown in 256-step
        buckets. Paged (the default above 32 slots): the page pool with the
        paged decode kernel. ``refill_batch`` caps every prefill group (0:
        whole groups up to 64 slots, else 32 rows); admission is
        longest-first. With every request fitting the slots (or nothing able
        to finish early) the dense branch is one ``generate``."""
        images_per_sample = samples.get("images", [])
        raw = bool(samples.get("raw_prompts"))
        texts = (samples.get("raw_prompts") or samples.get("answers")
                 or samples.get("prompts"))
        n = len(texts)
        max_tokens = int(max_new_tokens or self.max_tokens)
        slots = int(slots or min(n, self.max_num_seqs))
        if paged is None:
            paged = slots > 32
        slots = min(slots, n)
        if not paged and (n <= slots or max_tokens <= chunk or self.ignore_eos):
            return self._generate(samples, max_new_tokens=max_new_tokens,
                                  seed=seed)
        # length-determined serving (no EOS scan, no value-reading stop
        # hook): tokens stay lazy device->host copies until the end, and
        # preadmitted first tokens are gathered on the device
        lazy_tok = bool(paged and (self.ignore_eos or not self.eos_ids)
                        and self.stop_fn is None and self.lazy_tokens)
        # pipelined EOS accounting: chunk c's tokens are read after chunk
        # c + lag is dispatched; EOS lands up to lag chunks late, outputs
        # are still cut exactly, and greedy streams are unchanged
        lag = 0 if lazy_tok or not paged else max(0, self.eos_lag)

        tp0 = time.perf_counter()
        if preprepared is not None:
            if len(preprepared["prepared"]) != n:
                raise ValueError(
                    f"generate_many: preprepared holds "
                    f"{len(preprepared['prepared'])} requests, samples {n}")
            prepared = preprepared["prepared"]
            self._img_bank = preprepared["img_bank"]
            prep_phases = dict(preprepared["phases"], overlapped=1.0)
        else:
            prepared, self._img_bank, prep_phases = self._prepare(
                texts, images_per_sample, raw=raw)
        t_prepare = time.perf_counter() - tp0
        # longest-first: early refill groups get the big prompt buckets
        order = sorted(range(n), key=lambda i: -len(prepared[i]["ids"]))
        queue = list(order)
        generator = torch.Generator(device=self.device).manual_seed(seed)

        max_prompt = max(len(p["ids"]) for p in prepared)
        prompt_bucket = min(1 << max(6, (max_prompt - 1).bit_length()),
                            self.max_prompt_len)
        # + chunk: a slot finishing mid-chunk writes garbage KV rows until
        # the chunk boundary
        cache_size = prompt_bucket + max_tokens + chunk

        page = self.kv_page_size
        wave = 0
        pools = caches = table_dev = None
        if paged:
            if not (page <= 64 and 64 % page == 0):
                raise ValueError("kv_page_size must divide the 64-token "
                                 "minimum prompt bucket")
            hd, hkv = self.cfg.head_dim, self.lm.local_kv_heads()
            # pages a request can ever hold: its own prompt + max_tokens,
            # + chunk * (1 + lag) for the garbage a finished slot writes
            # until its finish is accounted
            need = [-(-(len(p["ids"]) + max_tokens + chunk * (1 + lag))
                      // page) for p in prepared]
            mp = max(need)
            # longest-first admission makes the initial fill the worst
            # concurrent set: the S largest, + 1 for the trash page
            pool_pages = 1 + sum(sorted(need, reverse=True)[:slots])
            wave = self.preadmit_wave if n > slots else 0
            if wave:
                # prefill-ahead holds prompt pages only; at most ~1.5 waves
                # are held at once (_preadmit refires at <= wave // 2)
                rest = order[slots:]
                pneed = sorted((-(-len(prepared[r]["ids"]) // page)
                                for r in rest), reverse=True)
                pool_pages += sum(pneed[:min((3 * wave + 1) // 2, len(rest))])
            free = list(range(pool_pages - 1, 0, -1))
            table_np = np.zeros((slots, mp), np.int32)
            slot_pages: List[List[int]] = [[] for _ in range(slots)]
            shape = (pool_pages, hkv, page, hd)
            pools = [(torch.zeros(shape, dtype=self.cfg.dtype,
                                  device=self.device),
                      torch.zeros(shape, dtype=self.cfg.dtype,
                                  device=self.device))
                     for _ in range(self.cfg.num_layers)]
            table_dev = self._tensor(table_np, torch.int32)
        else:
            caches = self._new_caches(slots, cache_size)

        # ---- slot state (populated by _admit / _assign) ----
        results: Dict[int, Tuple] = {}
        slot_req = [-1] * slots
        slot_tokens: List[List[Any]] = [[] for _ in range(slots)]
        slot_hidden: List[List[Any]] = [[] for _ in range(slots)]
        slot_prompt_hidden: List[Any] = [None] * slots
        slot_gen = np.zeros((slots,), np.int64)
        slot_active = np.ones((slots,), bool)
        # first chunk index whose rows belong to the slot's current request
        # (earlier in-flight chunks decoded another request: eos_lag)
        valid_from = np.zeros((slots,), np.int64)

        dev = self.device
        tokens_dev = torch.zeros((slots,), dtype=torch.long, device=dev)
        cache_len = torch.zeros((slots,), dtype=torch.long, device=dev)
        pos = torch.zeros((slots,), dtype=torch.long, device=dev)
        gen_count = torch.ones((slots,), dtype=torch.long, device=dev)
        group = (int(refill_batch) if refill_batch
                 else (slots if slots <= 64 else 32))
        # first tokens of admitted groups, read at the next accounting pass
        pending_first: List[Tuple[_HostCopy, List[int]]] = []
        n_chunks = 0

        def _admit(reqs, slot_ids):
            """Prefill ``reqs`` into ``slot_ids`` in groups of <= ``group``
            rows (initial fill and refills alike); each group gets its own
            prompt bucket."""
            nonlocal table_dev, tokens_dev, cache_len, pos, gen_count
            for g0 in range(0, len(reqs), group):
                g_reqs = list(reqs[g0:g0 + group])
                g_slots = list(slot_ids[g0:g0 + group])
                batch = [prepared[r] for r in g_reqs]
                for j, si in enumerate(g_slots):
                    slot_req[si] = g_reqs[j]
                if paged:
                    r_pad = min(1 << max(6, (max(len(p["ids"]) for p in batch)
                                             - 1).bit_length()),
                                self.max_prompt_len)
                    (r_first, r_hidden, r_caches, r_lens, r_last,
                     r_start) = self._prefill(batch, max_tokens, generator,
                                              cache_size=r_pad)
                    for j, si in enumerate(g_slots):
                        free.extend(slot_pages[si])
                        k = need[slot_req[si]]
                        slot_pages[si] = [free.pop() for _ in range(k)]
                        table_np[si, :] = 0
                        table_np[si, :k] = slot_pages[si]
                    rows = self._tensor(self._page_rows(
                        table_np, g_slots, r_lens, r_pad, page))
                    for (kp, vp), (kd, vd) in zip(pools, r_caches):
                        commit_pages(kp, kd, rows)
                        commit_pages(vp, vd, rows)
                    table_dev = self._tensor(table_np, torch.int32)
                else:
                    (r_first, r_hidden, r_caches, r_lens, r_last,
                     r_start) = self._prefill(batch, max_tokens, generator,
                                              cache_size=cache_size)
                    sl_idx = self._tensor(g_slots)
                    for (kc, vc), (kd, vd) in zip(caches, r_caches):
                        kc[sl_idx] = kd.to(kc.dtype)
                        vc[sl_idx] = vd.to(vc.dtype)
                sl = self._tensor(g_slots)
                tokens_dev[sl] = r_first
                cache_len[sl] = self._tensor(r_lens)
                pos[sl] = self._tensor(r_start)
                gen_count[sl] = 1
                hid = _HostHidden([r_hidden])
                if lazy_tok:
                    cell = _token_cell(r_first)
                else:
                    pending_first.append((_HostCopy(r_first), g_slots))
                for j, si in enumerate(g_slots):
                    slot_tokens[si] = [("f", cell, j)] if lazy_tok else []
                    valid_from[si] = n_chunks
                    slot_hidden[si] = [("seed", hid, j, int(r_last[j]))]
                    slot_prompt_hidden[si] = ("prompt", hid, j, int(r_lens[j]))
                    slot_gen[si] = 1

        # ---- prefill-ahead store (paged only) ----
        # requests whose prompts are already prefilled into pool pages
        # (prompt pages only), first token sampled, hidden copies in flight:
        # assigning one to a freed slot is a page-table update
        ahead: List[Dict[str, Any]] = []

        def _preadmit():
            take = min(wave, len(queue))
            if take <= 0:
                return
            reqs = [queue.pop(0) for _ in range(take)]
            for g0 in range(0, take, group):
                g_reqs = reqs[g0:g0 + group]
                batch = [prepared[r] for r in g_reqs]
                r_pad = min(1 << max(6, (max(len(p["ids"]) for p in batch)
                                         - 1).bit_length()),
                            self.max_prompt_len)
                (r_first, r_hidden, r_caches, r_lens, r_last,
                 r_start) = self._prefill(batch, max_tokens, generator,
                                          cache_size=r_pad)
                rows, pages_of = [], []
                for j, r in enumerate(g_reqs):
                    npg = -(-r_lens[j] // page)
                    pgs = [free.pop() for _ in range(npg)]
                    pages_of.append(pgs)
                    rows.extend(pgs + [0] * (r_pad // page - npg))
                rows = self._tensor(rows)
                for (kp, vp), (kd, vd) in zip(pools, r_caches):
                    commit_pages(kp, kd, rows)
                    commit_pages(vp, vd, rows)
                # one cell per prefill group, shared by its entries: resolved
                # once, at the group's first assignment
                cell = _token_cell(r_first)
                hid = _HostHidden([r_hidden])
                for j, r in enumerate(g_reqs):
                    ahead.append({
                        "req": r, "cell": cell, "row": j, "stamp": n_chunks,
                        "pages": pages_of[j], "plen": int(r_lens[j]),
                        "start": int(r_start[j]),
                        "seed": ("seed", hid, j, int(r_last[j])),
                        "prompt": ("prompt", hid, j, int(r_lens[j])),
                    })

        def _assign(slot_ids):
            """Point freed slots at prefill-ahead entries (FIFO)."""
            nonlocal tokens_dev, cache_len, pos, gen_count, table_dev
            entries = [ahead.pop(0) for _ in slot_ids]
            firsts = []
            for a, si in zip(entries, slot_ids):
                free.extend(slot_pages[si])
                k = need[a["req"]]
                slot_pages[si] = a["pages"] + [
                    free.pop() for _ in range(k - len(a["pages"]))]
                table_np[si, :] = 0
                table_np[si, :k] = slot_pages[si]
                cell = a["cell"]
                if lazy_tok:
                    # a device-side gather: no host sync on the refill path
                    firsts.append(cell["dev"][a["row"]])
                    slot_tokens[si] = [("f", cell, a["row"])]
                else:
                    tok = int(_tokcell(cell)[a["row"]])
                    firsts.append(tok)
                    slot_tokens[si] = [tok]
                slot_req[si] = a["req"]
                slot_hidden[si] = [a["seed"]]
                slot_prompt_hidden[si] = a["prompt"]
                slot_gen[si] = 1
                valid_from[si] = n_chunks
            table_dev = self._tensor(table_np, torch.int32)
            sl = self._tensor(slot_ids)
            tokens_dev[sl] = (torch.stack(firsts) if lazy_tok
                              else self._tensor(firsts))
            cache_len[sl] = self._tensor([a["plen"] for a in entries])
            pos[sl] = self._tensor([a["start"] for a in entries])
            gen_count[sl] = 1

        # ---- initial fill ----
        tp0 = time.perf_counter()
        _admit([queue.pop(0) for _ in range(slots)], list(range(slots)))
        if wave:
            _preadmit()  # wave 1 queues behind the initial fill
        t_first = time.perf_counter() - tp0

        def _finish(si):
            req = slot_req[si]
            toks = slot_tokens[si]
            if lazy_tok:
                # pieces stay lazy; the cut is the host-side count
                cut = min(int(slot_gen[si]), max_tokens)
                results[req] = (None, list(prepared[req]["ids"]),
                                ("lazy", list(toks), cut),
                                slot_prompt_hidden[si],
                                (list(slot_hidden[si]), cut),
                                prepared[req]["prompt"])
                return
            cut = min(self._cut_at_eos(toks), max_tokens)
            toks = toks[:cut]
            results[req] = (self._detok(toks), list(prepared[req]["ids"]),
                            toks, slot_prompt_hidden[si],
                            (list(slot_hidden[si]), cut),
                            prepared[req]["prompt"])

        timers = {"decode": 0.0, "sync": 0.0, "refill": 0.0, "account": 0.0}
        pending_acct: List[Tuple[Any, _HostHidden, int]] = []

        def _account(tok, chunk_hidden, cidx):
            """Token accounting, EOS / stop checks, finishes and refills for
            chunk ``cidx``. ``tok``: an (S, chunk) numpy array (synchronous),
            a _HostCopy (eos_lag: read here, lag chunks after dispatch), or a
            lazy cell (lazy tokens: never read here)."""
            if isinstance(tok, _HostCopy):
                ts = time.perf_counter()
                tok = tok.resolve().numpy()
                timers["sync"] += time.perf_counter() - ts
            ta0 = time.perf_counter()
            for first_copy, g_slots in pending_first:
                arr = first_copy.resolve().numpy()
                for j, si in enumerate(g_slots):
                    slot_tokens[si].insert(0, int(arr[j]))
            pending_first.clear()
            finished_slots = []
            for si in range(slots):
                if not slot_active[si] or cidx < valid_from[si]:
                    continue
                take = min(chunk, max_tokens - slot_gen[si])
                if lazy_tok:
                    slot_tokens[si].append(("c", tok, si, int(take)))
                else:
                    slot_tokens[si].extend(int(t) for t in tok[si, :take])
                slot_hidden[si].append(("gen", chunk_hidden, si, int(take)))
                slot_gen[si] += take
                done = slot_gen[si] >= max_tokens
                if not done and not self.ignore_eos and self.eos_ids:
                    done = any(t in self.eos_ids
                               for j, t in enumerate(slot_tokens[si])
                               if j >= self.min_tokens - 1)
                if not done and self.stop_len_fn is not None:
                    done = bool(self.stop_len_fn(slot_req[si],
                                                 int(slot_gen[si])))
                if not done and self.stop_fn is not None:
                    done = bool(self.stop_fn(slot_req[si], slot_tokens[si]))
                if done:
                    _finish(si)
                    finished_slots.append(si)
            timers["account"] += time.perf_counter() - ta0

            if finished_slots:
                t0 = time.perf_counter()
                assign_slots, refill_reqs, refill_slots = [], [], []
                # prefer entries preadmitted at least one chunk ago (their
                # first-token copies have landed); same-chunk ones last
                avail = sum(1 for a in ahead if a["stamp"] < n_chunks)
                hot = len(ahead) - avail
                for si in finished_slots:
                    if avail > 0:
                        assign_slots.append(si)
                        avail -= 1
                    elif queue:
                        refill_reqs.append(queue.pop(0))
                        refill_slots.append(si)
                    elif hot > 0:
                        assign_slots.append(si)
                        hot -= 1
                    else:
                        slot_active[si] = False
                if assign_slots:
                    _assign(assign_slots)
                if refill_reqs:
                    _admit(refill_reqs, refill_slots)
                if wave and len(ahead) <= wave // 2 and queue:
                    _preadmit()
                timers["refill"] += time.perf_counter() - t0

        pack = self._fused_sampler_pack() if paged else None
        t_loop0 = time.perf_counter()
        while slot_active.any():
            t0 = time.perf_counter()
            if paged:
                (tokens_dev, cache_len, pos, gen_count, chunk_tokens,
                 chunk_hidden) = self._chunk_decode(
                    pools, tokens_dev, cache_len, pos, gen_count, chunk,
                    generator, page_table=table_dev, pack=pack)
            else:
                max_len = int(cache_len.cpu().numpy()[slot_active].max()) + chunk
                window = min(-(-max_len // 256) * 256, cache_size)
                (tokens_dev, cache_len, pos, gen_count, chunk_tokens,
                 chunk_hidden) = self._chunk_decode(
                    caches, tokens_dev, cache_len, pos, gen_count, chunk,
                    generator, attn_window=window)
            t1 = time.perf_counter()
            # hidden copies stream behind later work; only the token matrix
            # can block the loop, and not in the lazy and eos_lag modes
            chunk_hidden = _HostHidden([chunk_hidden])
            if lazy_tok:
                tok = _token_cell(chunk_tokens)
            elif lag:
                tok = _HostCopy(chunk_tokens)
            else:
                ts = time.perf_counter()
                tok = chunk_tokens.cpu().numpy()
                timers["sync"] += time.perf_counter() - ts
            timers["decode"] += t1 - t0
            n_chunks += 1
            pending_acct.append((tok, chunk_hidden, n_chunks - 1))
            while len(pending_acct) > lag:
                _account(*pending_acct.pop(0))
        while pending_acct:  # eos_lag tail: the chunks still in flight
            _account(*pending_acct.pop(0))

        # wall-time breakdown, the JAX engine's keys: prepare_* (host resize,
        # np.stack of pixel batches, vision, prompt build), first_prefill
        # (initial fill), decode_dispatch (issuing chunk steps; on the card
        # this includes the host's own step time), decode_sync (waiting for
        # token copies), account (host bookkeeping), refill_prefill (refill
        # and prefill-ahead groups), decode_loop_total, final_resolve
        # the rank's KV pages (paged) or dense caches, k and v
        self.last_kv_bytes = sum(t.numel() * t.element_size()
                                 for pair in (pools or caches) for t in pair)
        self.last_phase_stats = {
            "n_requests": n, "slots": slots, "chunks": n_chunks,
            "prepare_total": round(t_prepare, 3),
            "prepare_resize": round(prep_phases["resize"], 3),
            "prepare_vispack": round(prep_phases["vision_pack"], 3),
            "prepare_vision": round(prep_phases["vision"], 3),
            "prepare_prompt": round(prep_phases["prompt"], 3),
            "first_prefill": round(t_first, 3),
            "decode_dispatch": round(timers["decode"], 3),
            "decode_sync": round(timers["sync"], 3),
            "account": round(timers["account"], 3),
            "refill_prefill": round(timers["refill"], 3),
            "decode_loop_total": round(time.perf_counter() - t_loop0, 3),
        }

        def _hid(piece):
            kind, h, row, k = piece
            arr = h.resolve()
            return arr[row, k][None] if kind == "seed" else arr[row, :k]

        t0 = time.perf_counter()
        final = []
        for i in range(n):
            text, ids, toks, prompt_piece, (gen_pieces, cut), prm = results[i]
            if isinstance(toks, tuple) and toks[0] == "lazy":
                _, pieces, tcut = toks
                out = []
                for p in pieces:
                    if p[0] == "f":
                        out.append(int(_tokcell(p[1])[p[2]]))
                    else:
                        out.extend(int(t) for t in _tokcell(p[1])[p[2], :p[3]])
                toks = out[:tcut]
                text = self._detok(toks)
            hid = torch.cat([_hid(p) for p in gen_pieces], dim=0)[:cut]
            final.append((text, ids, toks, _hid(prompt_piece), hid, prm))
        self.last_phase_stats["final_resolve"] = round(
            time.perf_counter() - t0, 3)
        cols = list(zip(*final))
        return GenerationResult(
            texts=list(cols[0]), prompt_token_ids=list(cols[1]),
            output_token_ids=list(cols[2]),
            prompt_hidden_states=list(cols[3]),
            hidden_states=list(cols[4]), input_prompts=list(cols[5]))


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
        kv_page_size=int(vcfg.get("kv_page_size", vcfg.get("block_size", 64))),
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

    default_model_type = "pretrain_mllama_vllm_generate_1"
    PRETRAINED_MODEL_CONFIG_DICT = {
        "pretrain_mllama_vllm_generate_1":
            "configs/models/mllama_vllm_generate_1.yaml",
    }

    def __init__(self, cfg: Dict[str, Any], engine: Optional[EmbedEngine] = None,
                 device="cuda"):
        self.cfg = cfg
        self.engine = (engine if engine is not None
                       else EmbedEngine.from_config(cfg, device=device))
        vcfg = cfg.get("vllm_config", {}) or {}
        self.embedding_layer_name = vcfg.get("embedding_layer_name", "model.norm")
        self.text_input_key = cfg.get("text_input_key", None) or "answers"
        model_id = str(cfg.get("mllama_model_id",
                               cfg.get("mllama_pretrained_model_name_or_path",
                                       "")))
        self._strip_leading_space = any(
            name in model_id for name in _LLAVA_LEADING_SPACE_IDS)
        self.max_num_seqs = int(vcfg.get("max_num_seqs", 32))

    default_config_path = classmethod(model_default_config_path)

    @classmethod
    def from_config(cls, cfg, device="cuda"):
        return cls(cfg, device=device)

    def load_checkpoint_from_config(self, cfg):
        pass  # frozen inference model

    def forward(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        """Host batch (any size) -> image-size-sorted groups of
        4 * max_num_seqs requests, each continuously batched over
        max_num_seqs slots -> merged results in the original order."""
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
