"""Input generators, one module each, found by the `generator` a
configuration names: `generate(params, seed, outdir) -> {"files": {name:
path}, "records": {name: n}, "bases": {name: n}, "reads":
{name: (codes, lengths)}}`, where `reads` holds each file's records as the
reference takes them: their bases as codes 0-4 (ACGT, N) one after another,
and each record's length. The same seed gives the same bytes."""

import zlib


def gzip_member(data: bytes, level: int) -> bytes:
    """One gzip member of data (a file may hold several, one after another)."""
    z = zlib.compressobj(level, zlib.DEFLATED, 31)
    return z.compress(data) + z.flush()
