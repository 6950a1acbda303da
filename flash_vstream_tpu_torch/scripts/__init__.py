"""Probe scripts of the port: the counterparts of the JAX package's
scripts/probe_bank_gather.py and scripts/probe_vit_variants.py, run as
`python -m flash_vstream_tpu_torch.scripts.<name>`."""
