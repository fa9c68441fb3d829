"""Probe scripts of the port: the measurements that drive kernels D and E,
those of the bench and entry layer, and those of kernels A, B and C.

The port of the repository's ``benchmarks/`` probes, all but
``block_probe`` and ``epilogue_probe`` (both measure TPU workarounds): those
that run the last two TPU kernels, the merge and primitive probes that give
those kernels their yardsticks, and the rest:

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
* ``primitives``: the library sort, gather, searchsorted and cumsum times;
* the bench-layer probes: ``e2e`` (amortized Gbp/s at the bench
  shapes), ``mesh_dedup_probe`` (the streaming mesh's raw, adaptive and
  dedup transports), ``merge_probe`` (the accumulator merge's sort, count
  and compaction at 151M rows, with and without kernel C),
  ``stream_probe`` (host dispatch against fenced device seconds) and
  ``skew`` (LPT against hash placement on a repeat-rich corpus);
* the probes of kernels A, B and C: ``bigk_probe`` (extract plus count at
  k = 28-201, the plain extract against kernel A), ``smer_pallas_probe``
  (the super-k-mer mesh step with kernel B against the plain extractor),
  ``pallas_sort_probe`` (kernel C by block size against one
  ``torch.sort``) and ``scaling`` (the per-batch mesh step, kernel B, at
  mesh sizes 1-8).

Each runs as ``python -m fastkmer_tpu_torch.benchmarks.<name>`` and on the
card unless it is given ``--device cpu``; there its kernels run, and on the
CPU their plain versions, so a kernel arm and a plain arm are then the same
code and the times are CPU times.  Each prints one JSON line per measure,
naming the device it ran on.
"""
