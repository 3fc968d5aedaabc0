"""The system under test for configurations of "system": "boolean_adder":
the port's ripple-carry adder (concrete_tpu_torch.boolean.circuits.
ripple_carry_adder) over its ServerKey gates, from host bit planes of two
columns of encrypted integers to their sums and carry on the host.

It is systems/boolean.py's System with an add in a gate call's place: the
same keys from the seed and ServerKey, XOR, AND and MUX warmed at the
mix's tiers. The mix gives the integers' width ("bits") and a request's
size in gate rows, (3 bits - 1) a pair of integers, so that the rate of
gate rows counts every gate of an add. The pool holds input batches of
integers uniform on [0, 2^bits), as little-endian bit planes [bits, m,
n+1] encrypted by plain/boolean.py. A checked gate row i checks the pair
i // (3 bits - 1), each pair once; the check runs the plain adder
(plain/adder.py) on every checked pair and compares every word of the sum
planes and the carry, and the decrypted sums with a + b.
"""

from __future__ import annotations

import numpy as np
import torch
from concrete_tpu_torch.boolean import circuits

from ..plain import adder as plain_adder
from ..plain import boolean as plain
from . import boolean


class System(boolean.System):

    def __init__(self, config: dict, mix: dict, device, seed: int):
        super().__init__(config, mix, device, seed)
        self.width = int(mix["bits"])
        self.per_add = plain_adder.gate_rows(self.width)

    def warm(self):
        self.server.warmup(batch_sizes=tuple(self.mix["tiers"]),
                           gates=("xor", "and"), mux=True)
        self.backend = self.server.resolved_backend()

    def integers(self, rows: int) -> int:
        """Pairs of integers a request of `rows` gate rows adds."""
        if rows % self.per_add:
            raise ValueError(f"{rows} gate rows is no whole number of "
                             f"{self.width}-bit adds ({self.per_add} each)")
        return rows // self.per_add

    def prepare_closed(self, batches: int, rows: int):
        m, hi = self.integers(rows), 1 << self.width
        self.pool = []
        for _ in range(batches):
            ints = [torch.randint(0, hi, (m,), generator=self.gen,
                                  device=self.device) for _ in range(2)]
            planes = [plain_adder.encrypt(self.gen, self.keys, self.p, v,
                                          self.width) for v in ints]
            self.pool.append([(boolean._u32(c), v.cpu().numpy())
                              for c, v in zip(planes, ints)])

    # -- the timed path ------------------------------------------------------

    def call(self, request) -> np.ndarray:
        (a, _), (b, _) = request.inputs
        sums, carry = circuits.ripple_carry_adder(self.server, a, b)
        return torch.cat([sums, carry[None]]).cpu().numpy()

    def checked(self, request) -> np.ndarray:
        """The pairs a request's checked gate rows fall in, each once."""
        return np.unique(request.check_idx // self.per_add)

    def keep(self, request, out):
        m = self.integers(request.rows)
        want = (self.width + 1, m, self.p["lwe_dimension"] + 1)
        if out.shape != want:
            raise ValueError(f"output shape {out.shape}, expected {want}")
        self.kept[request.id] = out[:, self.checked(request)].view(
            np.uint32).copy()

    # -- after the window ----------------------------------------------------

    def pbs_rows(self, op: str, rows: int) -> int:
        """Rows an add's blind rotations take: two for each of the half
        adder's gates, four for each full adder's (two gates and a MUX)."""
        return self.integers(rows) * (4 * self.width - 2)

    def operands(self, op: str) -> int:
        """An add takes two operands, a and b."""
        return 2

    def check(self, requests) -> dict:
        """{name: (value, "<=" or ">=", limit)} over the checked pairs of
        every answered request: words of the sum planes and the carry
        unequal to the plain adder's, and pairs whose decrypted sum or
        carry differs from a + b."""
        done = [r for r in requests if r.id in self.kept]
        if not done:
            return {"mismatched_words": (0, "<=", 0),
                    "wrong_sums": (0, "<=", 0),
                    "rows_checked": (0, ">=", 1)}
        idx = [self.checked(r) for r in done]
        a_ct, b_ct = (boolean._i64(np.concatenate(
            [r.inputs[j][0][:, i] for r, i in zip(done, idx)], axis=1),
            self.device) for j in range(2))
        a, b = (torch.from_numpy(np.concatenate(
            [r.inputs[j][1][i] for r, i in zip(done, idx)])).to(self.device)
            for j in range(2))
        got = boolean._i64(np.concatenate([self.kept[r.id] for r in done],
                                          axis=1), self.device)
        sums, carry = plain_adder.add(self.keys, self.p, a_ct, b_ct)
        want = torch.cat([sums, carry[None]])
        mismatched = int((got != want).sum())
        total = a + b
        hi = 1 << self.width
        wrong = ((plain_adder.decrypt(self.keys, got[:-1]) != total % hi)
                 | (plain.decrypt(self.keys, got[-1])
                    != (total >= hi)))
        return {"mismatched_words": (mismatched, "<=", 0),
                "wrong_sums": (int(wrong.sum()), "<=", 0),
                "rows_checked": (int(a.shape[0]), ">=", 1)}
