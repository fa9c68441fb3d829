"""fastkmer_tpu_torch — exact canonical k-mer counting in PyTorch on CUDA.

A port of ``fastkmer_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA H100.
The JAX package stays the reference: for the same input this package writes
byte-identical per-bin files, ``counts.npz`` arrays and manifests.

Only the device half is ported.  The JAX-free host modules of
``fastkmer_tpu`` are imported, never copied:

* ``config.JobConfig`` (positionals, derived bin count, output naming)
* ``core.bits`` (ASCII codes, packing, host reference bit ops)
* ``ingest.{batch,fasta,prefetch,native}`` (FASTA/FASTQ -> [R, L] code batches)
* ``output.{writer,manifest,native}`` (per-bin files, npz, manifests, k-way merge)
* ``utils.timing.StageTimer``

This package imports ``torch`` and never ``jax``.  Packed k-mer words are
``torch.int32`` tensors that hold the uint32 bit pattern (the all-ones
sentinel is -1); see ``core.tbits``.
"""
