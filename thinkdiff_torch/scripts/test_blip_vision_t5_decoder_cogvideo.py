"""ThinkDiff-CLIP image + text into a CogVideoX-5b video: the image through
the BLIP-2 ViT-g, the x2 pool and the projector, its first 65 tokens, then
the T5 text embeds of ``run.text_input`` (at most 226 - 65 = 161 tokens),
through 50 v-prediction DDIM steps at guidance 6, the 3D causal VAE (tiled
at this size) -> a video at ``{output_dir}/{image name}_seed{seed}.mp4``.

    python -m thinkdiff_torch.scripts.test_blip_vision_t5_decoder_cogvideo \\
        --cfg-path configs/test_thinkdiff_clip_video_text.yaml \\
        --options run.image_path=x.jpg run.text_input="..." [--device cpu]

The run section is read as the JAX script reads it, quirks included:
  - ``run.num_frames`` is the number of LATENT frames (default 13: 49
    frames out); the YAML's 49 is the pixel count, so the YAML as written
    asks for 49 latent frames (193 frames out) unless it is overridden;
  - ``run.latent_height`` / ``run.latent_width`` (default 60 / 90: 480 x
    720), not the YAML's ``video_height`` / ``video_width``;
  - ``run.image_path`` and ``run.text_input``, which the YAML lacks (it has
    ``img_urls`` and ``questions``); ``run.image_size`` (default 224) sizes
    the processor;
  - ``run.num_inference_steps``, ``guidance_scale``, ``seed``, ``fps``,
    ``video_format`` (default mp4: cv2 or ffmpeg, else an AVI beside the
    name), ``save_latents``, ``cogvideo_model`` and ``t5_model``.
CogVideoX's weights come from the local ``run.cogvideo_model`` checkpoint
(transformer and VAE decoder keys in one state dict, as JAX reads it);
without it the run raises FileNotFoundError. The initial noise comes from
a ``torch.Generator`` seeded with ``seed`` (not JAX's draw: the same seed
gives another video than the JAX script).
"""

from __future__ import annotations

import os

from thinkdiff_torch.scripts.common import bootstrap, parse_args

VISION_TOKEN_BUDGET = 65
TOTAL_TOKEN_BUDGET = 226


def load_cogvideo(path: str, device):
    """CogVideoX-5b's sampler (bf16 transformer) and VAE decoder from a
    local checkpoint: (sampler, decoder). Raises FileNotFoundError when it
    is not on disk; never downloads."""
    from thinkdiff_torch.models.bridge import load_params, local_hf_state_dict
    from thinkdiff_torch.models.cogvideox import (
        CogVideoXConfig, CogVideoXSampler, CogVideoXTransformer,
        convert_cogvideox)
    from thinkdiff_torch.models.cogvideox_vae import (
        CogVideoXVAEConfig, CogVideoXVAEDecoder, convert_cogvideox_vae)

    sd = local_hf_state_dict(path)
    if sd is None:
        raise FileNotFoundError("CogVideoX weights not found locally")
    ccfg = CogVideoXConfig.cogvideox_5b()
    sampler = CogVideoXSampler(ccfg, load_params(
        CogVideoXTransformer(ccfg, device=device), convert_cogvideox(sd)),
        device=device)
    decoder = load_params(CogVideoXVAEDecoder(
        CogVideoXVAEConfig.cogvideox_5b(), device=device),
        convert_cogvideox_vae(sd))
    return sampler, decoder


def main(argv=None):
    args = parse_args("ThinkDiff-CLIP -> CogVideoX video (PyTorch)", argv)
    cfg, task = bootstrap(args)
    run = cfg.run_cfg

    import numpy as np
    import torch
    from PIL import Image

    from thinkdiff_torch.data.processors import BlipImageEvalProcessor
    from thinkdiff_torch.data.video_io import save_video
    from thinkdiff_torch.engines.pipeline import T5TextEmbedder
    from thinkdiff_torch.models.cogvideox_vae import decode_latents

    model = task.build_model(cfg)
    proc = BlipImageEvalProcessor(image_size=int(run.get("image_size", 224)))
    image_path = run.get("image_path")
    prompt = run.get("text_input", "")
    out_dir = run.get("output_dir", "output/clip_cogvideo")
    seed = int(run.get("seed", 42))

    vision_tokens = model.forward_encoder(
        proc(Image.open(image_path))[None])[0].float()[:VISION_TOKEN_BUDGET]
    embedder = T5TextEmbedder.from_pretrained(
        run.get("t5_model", "google/flan-t5-xxl"), device=task.device)
    text_embeds = embedder(
        prompt, max_len=TOTAL_TOKEN_BUDGET - VISION_TOKEN_BUDGET)[0]
    cond = torch.cat([vision_tokens, text_embeds.to(vision_tokens.device)],
                     dim=0)[None]

    sampler, decoder = load_cogvideo(
        run.get("cogvideo_model", "THUDM/CogVideoX-5b"), task.device)
    latents = sampler.sample(
        cond, frames=int(run.get("num_frames", 13)),
        height=int(run.get("latent_height", 60)),
        width=int(run.get("latent_width", 90)),
        num_steps=int(run.get("num_inference_steps", 50)),
        guidance=float(run.get("guidance_scale", 6.0)), seed=seed)
    os.makedirs(out_dir, exist_ok=True)
    if run.get("save_latents", False):
        lat_path = os.path.join(out_dir, f"video_latents_seed{seed}.npy")
        np.save(lat_path, latents.cpu().numpy())
        print("saved latents:", lat_path)

    frames = decode_latents(decoder, latents)[0].cpu().numpy()
    name = os.path.splitext(os.path.basename(image_path))[0]
    out_path = os.path.join(
        out_dir, f"{name}_seed{seed}.{run.get('video_format', 'mp4')}")
    out_path = save_video(frames, out_path, fps=int(run.get("fps", 8)))
    print("saved video:", out_path)
    return out_path


if __name__ == "__main__":
    main()
