"""The multi-device splits (port of flash_vstream_tpu/parallel/).

Serving across devices: meshes and sharding rules (sharding.py),
tensor-parallel decode (inference.py) and the disaggregated ingest/decode
placement (serve.py), one controller over a list of devices. Training
across ranks, one process a rank over torch.distributed: the process
groups and collectives (collectives.py), the dp x (tp | pp | sp) grid of
ranks and ZeRO-3's resting shards (sharding.py), tensor-parallel training's
split leaves and Megatron regions (tensor.py), GPipe (pipeline.py) and
ring attention (sequence.py); data parallelism, ZeRO and moment offload
live in train/trainer.py."""
