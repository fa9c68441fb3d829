"""Seeded input of a count job from a traffic file, and its FASTA.

A traffic file names a ``shape`` and its parameters:

* ``assembly``: a genome of ``genome_bases`` uniform random bases in
  ``records`` records of equal length, each record one row;
* ``reads``: ``coverage`` x ``genome_bases`` / ``read_len`` reads of such a
  genome, at uniform starts, a ``reverse_share`` of them the reverse
  complement of their span, each base replaced by one of the other three
  with probability ``sub_rate`` (sequencing substitutions).

Either shape then gets runs of ``n_run`` N bases, started at a rate that
makes ``n_rate`` of the bases N, and is written as FASTA with
``line_width`` bases a line (0: one line a record).  Everything is drawn on
``device`` from one ``torch.Generator`` seeded by the run's seed, in a few
large calls, so a seed gives the same input on every card of one kind.

Started from ``chip_smoke.sample_reads`` / ``write_reads_fasta`` (the proof
script's data), vectorised and drawn on the card.
"""

from __future__ import annotations

import os

import torch

FASTA_HEADER = b">r\n"
ACGTN = torch.tensor(list(b"ACGTN"), dtype=torch.uint8)


def shape(traffic: dict) -> tuple:
    """(rows, bases a row) of the traffic's input."""
    G = traffic["genome_bases"]
    if traffic["shape"] == "assembly":
        return traffic["records"], G // traffic["records"]
    return traffic["coverage"] * G // traffic["read_len"], traffic["read_len"]


def input_bases(traffic: dict) -> int:
    n, ln = shape(traffic)
    return n * ln


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def _n_runs(rows: torch.Tensor, rate: float, run: int, g: torch.Generator) -> None:
    """Set runs of ``run`` N codes in place, started at rate / run a base."""
    if rate <= 0:
        return
    n, ln = rows.shape
    starts = torch.rand((n, ln), generator=g, device=rows.device) < rate / run
    c = torch.zeros((n, ln + 1), dtype=torch.int32, device=rows.device)
    torch.cumsum(starts, dim=1, out=c[:, 1:])
    i = torch.arange(1, ln + 1, device=rows.device)
    rows[(c[:, 1:] - c[:, (i - run).clamp(min=0)]) > 0] = 4


def rows(traffic: dict, seed: int, device) -> torch.Tensor:
    """[rows, bases a row] uint8 codes (A C G T = 0..3, N = 4) on device."""
    g = generator(seed, device)
    n, ln = shape(traffic)
    genome = torch.randint(0, 4, (traffic["genome_bases"],), generator=g, device=device,
                           dtype=torch.uint8)
    if traffic["shape"] == "assembly":
        out = genome[:n * ln].view(n, ln).clone()
    else:
        G = traffic["genome_bases"]
        starts = torch.randint(0, G - ln + 1, (n, 1), generator=g, device=device)
        out = genome[starts + torch.arange(ln, device=device)]
        del starts
        rev = torch.rand((n, 1), generator=g, device=device) < traffic["reverse_share"]
        out = torch.where(rev, 3 - out.flip(1), out)
        sub = torch.rand((n, ln), generator=g, device=device) < traffic["sub_rate"]
        shift = torch.randint(1, 4, (n, ln), generator=g, device=device, dtype=torch.uint8)
        out = torch.where(sub, (out + shift) % 4, out)
    del genome
    _n_runs(out, traffic["n_rate"], traffic["n_run"], g)
    return out


def fasta_bytes(codes: torch.Tensor, line_width: int = 0) -> torch.Tensor:
    """[n, len] codes -> [n, record bytes] uint8: one record ``>r\\n`` and
    its bases, ``line_width`` a line, each line ended by a newline, a row,
    so that the rows laid end to end are the FASTA file."""
    n, ln = codes.shape
    dev = codes.device
    w = line_width or ln
    lines = -(-ln // w)
    body = torch.zeros((n, lines * w), dtype=torch.uint8, device=dev)
    body[:, :ln] = ACGTN.to(dev)[codes.long()]
    body = torch.cat([body.view(n, lines, w),
                      torch.full((n, lines, 1), ord("\n"), dtype=torch.uint8, device=dev)],
                     dim=2).view(n, -1)
    if lines * w > ln:  # the last line is short: drop its padding
        keep = torch.ones(lines * (w + 1), dtype=torch.bool, device=dev)
        keep[(lines - 1) * (w + 1) + ln - (lines - 1) * w:-1] = False
        body = body[:, keep]
    head = torch.tensor(list(FASTA_HEADER), dtype=torch.uint8, device=dev).expand(n, -1)
    return torch.cat([head, body], dim=1)


def write_fasta(path: str, records) -> int:
    """Write host records (fasta_bytes, as numpy) and flush them to disk, so
    that no writeback of the input runs during the timed jobs -> bytes
    written."""
    with open(path, "wb") as f:
        records.tofile(f)
        f.flush()
        os.fsync(f.fileno())
    return int(records.size)
