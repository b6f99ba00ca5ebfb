"""Data-parallel and multi-host training on ``torch.distributed``: a shard
of the corpus is a rank of a process group (``train_dp``), and
``multihost`` brings the group up and loads each rank's byte range."""
