"""Multisequence counting with pairwise distances (``--multiseq``) — the
port of ``fastkmer_tpu.multiseq``: per-(k-mer, sequence) counts through
kernel A (single device) or kernel B (streaming mesh), and an S x S matrix
of distances between the sequences."""
