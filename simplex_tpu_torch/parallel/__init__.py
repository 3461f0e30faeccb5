"""Row-sharded and multi-process solves on ``torch.distributed`` (port of
``simplex_tpu/parallel/``): :mod:`.sharded` and :mod:`.distributed`."""
