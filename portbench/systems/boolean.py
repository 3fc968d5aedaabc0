"""The system under test for configurations of "system": "boolean": the
port's ServerKey gates (concrete_tpu_torch.boolean), from host ciphertext
arrays to results on the host.

Set-up makes the keys from the seed with the benchmark's own plain code
(plain/boolean.py), on the device, hands the standard-form keys to
ServerKey.from_arrays with the default backend ("auto"), whose set-up
derives its evaluation forms, and warms each (gate, tier) the mix uses.
The check runs the plain reference on the rows drawn for it and compares
every word, and the decrypted booleans with the gate's truth table.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..plain import boolean as plain

METHODS = {"and": "and_", "or": "or_", "nand": "nand", "nor": "nor",
           "xor": "xor", "xnor": "xnor", "mux": "mux"}


class System:
    bits = 32

    def __init__(self, config: dict, mix: dict, device, seed: int):
        self.config, self.mix, self.device = config, mix, torch.device(device)
        self.p = dict(config["parameters"], bits=self.bits)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed)
        self.kept = {}         # request id -> the program's checked rows
        self.pool = None

    # -- set-up --------------------------------------------------------------

    def setup(self) -> dict:
        """Keys, the program's objects, every shape warmed; returns the
        seconds of each part."""
        t0 = time.perf_counter()
        from concrete_tpu_torch.boolean import ServerKey
        from concrete_tpu_torch.dispersion import StandardDev
        from concrete_tpu_torch.params import BooleanParameters

        p = self.p
        self.keys = plain.make_keys(self.gen, p, self.device)
        _sync(self.device)
        t1 = time.perf_counter()
        params = BooleanParameters(
            lwe_dimension=p["lwe_dimension"],
            glwe_dimension=p["glwe_dimension"],
            polynomial_size=p["polynomial_size"],
            lwe_modular_std_dev=StandardDev(p["lwe_modular_std_dev"]),
            glwe_modular_std_dev=StandardDev(p["glwe_modular_std_dev"]),
            pbs_base_log=p["pbs_base_log"], pbs_level=p["pbs_level"],
            ks_base_log=p["ks_base_log"], ks_level=p["ks_level"])
        self.server = ServerKey.from_arrays(
            _u32(self.keys["bsk"]), _u32(self.keys["ksk"]), params,
            device=self.device)
        t2 = time.perf_counter()
        self.warm()
        _sync(self.device)
        return {"keys_s": t1 - t0, "program_s": t2 - t1,
                "warm_s": time.perf_counter() - t2}

    def warm(self):
        ops = self.mix["ops"]
        self.server.warmup(batch_sizes=tuple(self.mix["tiers"]),
                           gates=tuple(o for o in ops if o != "mux"),
                           mux="mux" in ops)
        self.backend = self.server.resolved_backend()

    def use_control(self):
        """Put the program's reduced-precision twin (the configuration's
        "control": ServerKey.with_fast_mode arguments) in its place."""
        self.server = self.server.with_fast_mode(**self.config["control"])
        self.warm()

    def _encrypt(self, counts: list[int]):
        """Fresh encryptions of random booleans, one host array [rows,
        n+1] np.uint32 (and the booleans) per entry of `counts`."""
        total = int(sum(counts))
        bits = torch.randint(0, 2, (total,), generator=self.gen,
                             device=self.device).bool()
        cts = plain.encrypt(self.gen, self.keys, self.p, bits)
        host = cts.to(torch.int32).cpu().numpy().view(np.uint32)
        bits = bits.cpu().numpy()
        edges = np.cumsum([0, *counts])
        return [(host[a:b], bits[a:b]) for a, b in zip(edges[:-1], edges[1:])]

    def prepare_open(self, requests):
        counts = [r.rows for r in requests
                  for _ in range(plain.OPERANDS[r.op])]
        parts = iter(self._encrypt(counts))
        for r in requests:
            r.inputs = [next(parts) for _ in range(plain.OPERANDS[r.op])]

    def prepare_closed(self, batches: int, rows: int):
        width = max(plain.OPERANDS[o] for o in self.mix["ops"])
        parts = self._encrypt([rows] * (batches * width))
        self.pool = [parts[i * width:(i + 1) * width] for i in range(batches)]

    def attach(self, request):
        request.inputs = self.pool[request.id % len(self.pool)]

    # -- the timed path ------------------------------------------------------

    def call(self, request) -> np.ndarray:
        cts = [ct for ct, _ in request.inputs[:plain.OPERANDS[request.op]]]
        out = getattr(self.server, METHODS[request.op])(*cts)
        return out.cpu().numpy()

    def keep(self, request, out):
        want = (request.rows, self.p["lwe_dimension"] + 1)
        if out.shape != want:
            raise ValueError(f"output shape {out.shape}, expected {want}")
        self.kept[request.id] = out[request.check_idx].view(np.uint32).copy()

    # -- after the window ----------------------------------------------------

    def free_program(self):
        self.server = None
        self.pool = None

    def pbs_rows(self, op: str, rows: int) -> int:
        """Rows the blind rotation takes for a request."""
        return rows * (2 if op == "mux" else 1)

    def operands(self, op: str) -> int:
        return plain.OPERANDS[op]

    def check(self, requests) -> dict:
        """{name: (value, "<=" or ">=", limit)} over the checked rows of
        every answered request: words unequal to the reference's, and
        outputs whose booleans differ from the truth table."""
        mismatched = wrong = checked = 0
        for op in sorted({r.op for r in requests}):
            done = [r for r in requests if r.op == op and r.id in self.kept]
            if not done:
                continue
            n_in = plain.OPERANDS[op]
            cts = [_i64(np.concatenate([r.inputs[j][0][r.check_idx]
                                        for r in done]), self.device)
                   for j in range(n_in)]
            bits = [torch.from_numpy(np.concatenate(
                [r.inputs[j][1][r.check_idx] for r in done])).to(self.device)
                for j in range(n_in)]
            got = _i64(np.concatenate([self.kept[r.id] for r in done]),
                       self.device)
            want = plain.gate(self.keys, self.p, op, cts)
            mismatched += int((got != want).sum())
            wrong += int((plain.decrypt(self.keys, got)
                          != plain.truth(op, bits)).sum())
            checked += got.shape[0]
        return {"mismatched_words": (mismatched, "<=", 0),
                "wrong_booleans": (wrong, "<=", 0),
                "rows_checked": (checked, ">=", 1)}


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.to(torch.int32).cpu().numpy().view(np.uint32)


def _i64(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(a.astype(np.int64)).to(device)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)
