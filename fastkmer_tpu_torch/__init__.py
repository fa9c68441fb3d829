"""fastkmer_tpu_torch — exact canonical k-mer counting in PyTorch on CUDA.

A port of ``fastkmer_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA H100.
The JAX package stays the reference: for the same input this package writes
byte-identical per-bin files, ``counts.npz`` arrays and manifests.

The package owns copies of the host modules it needs, at the same paths
as in ``fastkmer_tpu`` so that each has a visible counterpart:

* ``config.JobConfig`` (positionals, derived bin count, output naming)
* ``core.bits`` (ASCII codes, word counts, decode for output, k-mer pack)
* ``ingest.{batch,fasta,prefetch,native}`` (FASTA/FASTQ -> [R, L] code batches)
* ``output.{writer,manifest,native}`` (per-bin files, npz, manifests, k-way merge)
* ``parallel.partitioner`` (LPT and hash bin placement, exchange cap sizing)
* ``utils.{timing,nativebuild}`` (``StageTimer``; g++ builds of the native parts)

``bench`` times a synthetic stream of batches staged on the device, in its
modes; the benchmark is ``BENCHMARK.json``'s, run by ``kbench/``.  ``entry``
holds the entry points (``entry()``, ``dryrun_multichip(n)``).

This package imports ``torch`` and neither ``jax`` nor ``fastkmer_tpu``.  Packed k-mer words are
``torch.int32`` tensors that hold the uint32 bit pattern (the all-ones
sentinel is -1); see ``core.tbits``.
"""
