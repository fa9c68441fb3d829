"""Run configuration — the port's copy of ``fastkmer_tpu.config``.

Field-for-field equivalent of the reference's ``TestConfiguration``
(reference: src/main/scala/skc/test/package.scala:16-42) with the same
derived values (b = min(4^m, max_b); output-dir naming scheme) plus the
batching/mesh knobs the Spark runtime supplied implicitly.  Field order,
defaults and ``describe()`` are the JAX package's, byte for byte: the
manifest records the config, and the two packages' manifests must match.
"""

from __future__ import annotations

import dataclasses

DEBUG_DIRECTORY = "/tmp/"


@dataclasses.dataclass
class JobConfig:
    dataset: str
    output_directory: str
    k: int = 28
    m: int = 10
    x: int = 3
    max_b: int = 2000
    sequence_type: int = 0
    canonical: bool = True  # accepted-but-unused, like bothStrands (SparkBinKmerCounter.scala:34)
    debug: bool = False
    write: bool = True
    use_kryo_serializer: bool = False  # accepted for CLI parity; no-op (no JVM serialization)
    use_ht: bool = False
    use_custom_partitioner: bool = False
    num_partition_tasks: int = 0
    prefix: str = ""

    # --- TPU-native runtime knobs (Spark analogues in parentheses) ---
    reads_per_batch: int = 512  # rows per device batch (~input split)
    read_len: int = 4096  # max bases per row; longer reads are k-1-overlap chunked
    sample_fraction: float = 0.01  # partitioner pre-pass sample (SparkBinKmerCounter.scala:1024)

    def __post_init__(self) -> None:
        if self.k < 4:
            raise ValueError("k must be >= 4")
        if not (4 <= self.m <= 15):
            raise ValueError("m must be in [4, 15]")
        if self.m >= self.k:
            raise ValueError("m must be < k")
        if self.read_len < 2 * self.k:
            self.read_len = 2 * self.k

    @property
    def b(self) -> int:
        return min(4**self.m, self.max_b)

    @property
    def output_dir(self) -> str:
        base = DEBUG_DIRECTORY if self.debug else self.output_directory
        name = f"{self.prefix}k{self.k}_m{self.m}_x{self.x}_b{self.b}"
        if not self.debug:
            name += f"_s{self.sequence_type}"
        return base + name

    def describe(self) -> str:
        d = (
            "Kmer counting on TPU (fastkmer_tpu).\nTest parameters:\n"
            f"Dataset: {self.dataset}\nk: {self.k}\nm: {self.m}\nx: {self.x}\nb: {self.b}\n"
            f"Sequence type: {self.sequence_type}\nUsing HT:  {self.use_ht}\n"
            f"Writing: {self.write}\nUsing Kryo Serializer: {self.use_kryo_serializer}\n"
            f"Multiprocessor Scheduling Partitioning: {self.use_custom_partitioner}"
        )
        if self.use_custom_partitioner:
            d += f"\t no. partition tasks: {self.num_partition_tasks}"
        return d
