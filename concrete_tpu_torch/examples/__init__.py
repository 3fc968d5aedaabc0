"""The examples of concrete_tpu (examples/*.py), on the port's modules.

Each module has `run(device=None, ...)`, which does the work at the
reference's published parameters and sizes (smaller ones by keyword),
checks its own answers (AssertionError when one is wrong) and returns the
values it computed with the lines it printed under "lines", and
`main(argv=None, **sizes)`, which reads `--device` (default: the GPU) and
returns the printed lines:

    python -m concrete_tpu_torch.examples.boolean_gates [--device cuda]

Keys, and here also encryptions, come from fixed seeds, so a run is
reproducible (omit the seeds in production). Importing an example runs
nothing.
"""

from __future__ import annotations

import argparse

NAMES = ("boolean_gates", "fast_mode", "function_bootstrap", "int4_lut",
         "adder_circuit", "serving", "tpu128_codesign")


class Lines(list):
    """The lines an example prints, kept in order.

    >>> out = Lines()
    >>> out("a AND b =", [True, False])
    a AND b = [True, False]
    >>> out
    ['a AND b = [True, False]']
    """

    def __call__(self, *parts):
        line = " ".join(str(p) for p in parts)
        print(line, flush=True)
        self.append(line)


def expect(ok: bool, what: str):
    """An example's own check of its answer (kept under python -O)."""
    if not ok:
        raise AssertionError(what)


def parse(argv, doc: str, **extra) -> argparse.Namespace:
    """--device (default: the GPU; "cpu" runs the plain versions) and the
    example's own options (`extra`: name -> argparse keywords)."""
    parser = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    parser.add_argument("--device", default=None,
                        help="torch device (default: the GPU)")
    for name, kw in extra.items():
        parser.add_argument(name, **kw)
    return parser.parse_args(argv)
