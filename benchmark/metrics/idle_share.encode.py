"""Device, in the bulk encode cell: read as ``idle_share.train``."""

from benchmark.spec import same_as

read = same_as("idle_share.train")
