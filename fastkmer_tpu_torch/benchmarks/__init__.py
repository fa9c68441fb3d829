"""Probe scripts of the port: the measurements that drive kernels D and E.

The port of the repository's ``benchmarks/`` probes that run the last two
TPU kernels, and of the merge and primitive probes that give those kernels
their yardsticks:

* ``cuda_probe``: kernel E, two device-memory pass probes (a streaming +1
  and a 128 x 128 transpose-touch-transpose), ``csrc/pass_probe.cu``;
* ``cuda_bitonic_merge``: kernel D, the merge of [ascending | descending]
  halves (a merge path; the name is the JAX probe's),
  ``csrc/bitonic_merge.cu``;
* ``split_merge_probe``: one 2-key sort against two half sorts and kernel D;
* ``resume_merge_probe``: the host k-way merge of two sorted parts against
  a round trip through the card and kernel D;
* ``roofline``: per-call overhead, elementwise GB/s, sorts, the merge at its
  real shape;
* ``compact_probe``: the merge's default compaction against the block-sort
  route (kernel C) at the real shape;
* ``primitives``: the library sort, gather, searchsorted and cumsum times.

Each runs as ``python -m fastkmer_tpu_torch.benchmarks.<name>`` and on the
card unless it is given ``--device cpu``; each prints one JSON line per
measure, naming the device it ran on.
"""
