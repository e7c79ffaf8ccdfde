"""Data parallelism over GPUs and processes: the process group and its
helpers (``distributed``), the data-parallel train steps (``mesh``) and a
CPU or multi-GPU dry run of both (``dryrun``)."""
