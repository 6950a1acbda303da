"""Serving across devices (port of flash_vstream_tpu/parallel/, its serving
half): meshes and sharding rules (sharding.py), tensor-parallel decode
(inference.py) and the disaggregated ingest/decode placement (serve.py).
The training half (data parallelism with ZeRO, moment offload, pipeline and
sequence parallelism) is not ported yet: ROADMAP A16, training half."""
