"""Multi-device: the port of ``jpeg_tpu/parallel`` on ``torch.distributed``.

``distributed`` starts the process group (one process a rank, NCCL for
CUDA devices, gloo for the CPU) and assembles per-rank frame batches;
``sharding`` builds the ``('frame', 'tile')`` device mesh and the sharded
decode, encode and roundtrip pipelines, which run the port's kernels on
each rank's local tensors with explicit collectives between them;
``demo`` spawns local ranks (``python -m jpeg_tpu_torch.parallel.demo``).
"""
