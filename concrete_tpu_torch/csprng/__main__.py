"""Stream CSPRNG bytes to stdout, the `generate_random` binary's analog
(concrete-csprng/src/generate_random.rs:8):

    python -m concrete_tpu_torch.csprng [n_bytes] [--seed=SEED]

Without `n_bytes` it streams until the reader closes the pipe.

    >>> b"".join(chunks(5, seed=1)).hex() == AesCtrGenerator(key=1).generate_bytes(5).tobytes().hex()
    True
"""

from __future__ import annotations

import sys

from .generator import AesCtrGenerator


def chunks(total: int | None, seed: int | None = None, chunk: int = 1 << 16):
    """The stream's first `total` bytes (all of it when None), in chunks."""
    gen = AesCtrGenerator(key=seed)
    written = 0
    while total is None or written < total:
        n = chunk if total is None else min(chunk, total - written)
        yield gen.generate_bytes(n).tobytes()
        written += n


def main(argv: list[str] | None = None):
    argv = sys.argv[1:] if argv is None else argv
    args = [a for a in argv if not a.startswith("--")]
    seed = None
    for a in argv:
        if a.startswith("--seed"):
            seed = int(a.split("=", 1)[1])
    out = sys.stdout.buffer
    for block in chunks(int(args[0]) if args else None, seed):
        out.write(block)


if __name__ == "__main__":
    main()
