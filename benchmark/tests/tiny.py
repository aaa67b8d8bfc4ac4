"""Tiny copies of the cells' files, for runs of the harness on the CPU:
the same drivers, generators and references at small widths."""

import copy

from benchmark import harness


def train(dtype="bfloat16", **traffic):
    f = copy.deepcopy(harness.cell_files("train-lvlm-bs32"))
    c = f["config"]
    c["t5"].update(vocab_size=128, d_model=32, d_kv=8, d_ff=64, num_layers=2,
                   num_decoder_layers=2, num_heads=4)
    c["vlm_hidden_size"] = 24
    c["model"]["dtype"] = dtype
    f["traffic"]["params"].update(batch_size=4, pool_batches=4, max_split=16,
                                  max_txt=16, sort_window=8, **traffic)
    return f


def flux(dtype="bfloat16", batch=1):
    f = copy.deepcopy(harness.cell_files("flux-1024"))
    c = f["config"]
    c["transformer"].update(
        in_channels=16, num_layers=2, num_single_layers=2,
        attention_head_dim=16, num_attention_heads=4, joint_attention_dim=32,
        pooled_projection_dim=24, axes_dims_rope=[4, 6, 6])
    c["text_encoder"].update(
        vocab_size=100, hidden_size=24, intermediate_size=48,
        num_hidden_layers=2, num_attention_heads=4, bos_token_id=98,
        eos_token_id=99)
    c["vae"].update(latent_channels=4, block_out_channels=[8, 16],
                    layers_per_block=1, norm_num_groups=4)
    c["dtype"] = dtype
    c["run"]["num_inference_steps"] = 4
    f["traffic"]["params"].update(batch=batch, height=64, width=64, tokens=8)
    return f
