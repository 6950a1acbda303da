"""Scripts of the port: the counterparts of the JAX package's
scripts/probe_bank_gather.py, scripts/probe_vit_variants.py,
scripts/probe_int4_variants.py, scripts/merge_lora_weights.py and
scripts/extract_frames.py, run as
`python -m flash_vstream_tpu_torch.scripts.<name>`."""
