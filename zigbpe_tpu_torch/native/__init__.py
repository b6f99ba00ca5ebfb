"""The native host runtime: ``fastio.cpp`` (whole-file reads, a
single-core trainer and encoder with the reference's semantics, and the
byte-pair histogram that seeds the trainer's upper-bound table), bound
with ctypes by ``fastio``; and ``lists.cpp``, which builds the serving
path's lists of ids from a shared table of ints, bound by ``lists``."""
