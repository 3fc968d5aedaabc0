"""The system under test for configurations of "system": "int4_lut": the
port's high-level API (concrete_tpu_torch.highlevel) bootstrapping small
encrypted integers through a table (VectorLWE.bootstrap_all_with_function)
and keyswitching them back to the small key (VectorLWE.keyswitch), from
host arrays to results on the host.

Set-up makes the keys from the seed with the benchmark's own plain code
(plain/int4_lut.py), on the device, builds LWEBSK and LWEKSK on the
standard-form arrays with the default backend ("auto"), whose set-up
derives the evaluation forms, and warms every request size and function of
the mix. The check runs the plain reference on the rows drawn for it and
compares every word of the PBS output and of the keyswitched output, and
the integers the PBS outputs decrypt to under the big key with the table.
The keyswitched rows are not held to the table: at these parameters about
2.8% of them decrypt wrong by design (the keyswitch's noise).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..plain import int4_lut as plain


class System:
    bits = 64

    def __init__(self, config: dict, mix: dict, device, seed: int):
        self.config, self.mix, self.device = config, mix, torch.device(device)
        self.p = dict(config["parameters"], bits=self.bits)
        self.enc = config["encoder"]
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed)
        self.tables = mix["functions"]
        self.kept = {}
        self.pool = None

    # -- set-up --------------------------------------------------------------

    def setup(self) -> dict:
        """Keys, the program's objects, every shape warmed; returns the
        seconds of each part."""
        t0 = time.perf_counter()
        from concrete_tpu_torch.core.lwe import LweKeyswitchKey
        from concrete_tpu_torch.highlevel import LWEBSK, LWEKSK, Encoder

        p = self.p
        self.keys = plain.make_keys(self.gen, p, self.device)
        _sync(self.device)
        t1 = time.perf_counter()
        self.bsk = LWEBSK(
            cfg=LWEBSK._config(p["lwe_dimension"], p["glwe_dimension"],
                               p["polynomial_size"], p["pbs_base_log"],
                               p["pbs_level"]),
            variance=4.0 ** p["rlwe_log2_std_dev"],
            coefficient_bsk=_u64(self.keys["bsk"]), device=self.device)
        self.ksk = LWEKSK(
            inner=LweKeyswitchKey(_u64(self.keys["ksk"]), p["ks_base_log"],
                                  p["ks_level"], self.bits),
            variance=4.0 ** p["lwe_log2_std_dev"], device=self.device)
        e = self.enc
        self.encoder = Encoder.new(e["min"], e["max"], e["precision"],
                                   e["padding"])
        self.functions = {op: plain.function(self.tables[op])
                          for op in self.mix["ops"]}
        t2 = time.perf_counter()
        self.warm()
        _sync(self.device)
        return {"keys_s": t1 - t0, "program_s": t2 - t1,
                "warm_s": time.perf_counter() - t2}

    def warm(self):
        """One call at each request size the mix can send and one with
        each function: every graph captured, every host path run once."""
        from .. import traffic

        sizes = self.mix["sizes"]
        rows = ([int(sizes["rows"])] if sizes["kind"] == "fixed"
                else sorted({int(r) for r in traffic.sizes(
                    sizes, traffic.quantiles(4096))}))
        ops = self.mix["ops"]
        width = self.p["lwe_dimension"] + 1
        for r in rows:
            self._run(self._vector(np.zeros((r, width), np.uint64)), ops[0])
        for op in ops[1:]:
            self._run(self._vector(np.zeros((rows[0], width), np.uint64)), op)
        self.backend = self.bsk.resolved_backend()

    def use_control(self):
        """Put the program's reduced-precision twin (the configuration's
        "control": LWEBSK.with_fast_mode arguments) in its place."""
        self.bsk = self.bsk.with_fast_mode(**self.config["control"])
        self.warm()

    def _vector(self, data: np.ndarray):
        from concrete_tpu_torch.highlevel import VectorLWE

        var = 4.0 ** self.p["lwe_log2_std_dev"]
        return VectorLWE(data=data,
                         encoders=[self.encoder.copy() for _ in data],
                         variances=np.full(len(data), var))

    def _encrypt(self, counts: list[int]):
        total = int(sum(counts))
        values = torch.randint(0, 1 << self.enc["precision"], (total,),
                               generator=self.gen, device=self.device)
        cts = plain.encrypt(self.gen, self.keys, self.p, self.enc, values)
        host = cts.cpu().numpy().view(np.uint64)
        values = values.cpu().numpy()
        edges = np.cumsum([0, *counts])
        return [{"vector": self._vector(host[a:b]), "values": values[a:b]}
                for a, b in zip(edges[:-1], edges[1:])]

    def prepare_open(self, requests):
        parts = self._encrypt([r.rows for r in requests])
        for r, part in zip(requests, parts):
            r.inputs = part

    def prepare_closed(self, batches: int, rows: int):
        self.pool = self._encrypt([rows] * batches)

    def attach(self, request):
        request.inputs = self.pool[request.id % len(self.pool)]

    # -- the timed path ------------------------------------------------------

    def _run(self, vector, op: str):
        pbs = vector.bootstrap_all_with_function(self.bsk, self.functions[op],
                                                 self.encoder)
        return pbs.data, pbs.keyswitch(self.ksk).data

    def call(self, request):
        return self._run(request.inputs["vector"], request.op)

    def keep(self, request, out):
        big, small = out
        p = self.p
        want = ((request.rows, p["glwe_dimension"] * p["polynomial_size"] + 1),
                (request.rows, p["lwe_dimension"] + 1))
        if (big.shape, small.shape) != want:
            raise ValueError(f"output shapes {big.shape}, {small.shape}, "
                             f"expected {want}")
        idx = request.check_idx
        self.kept[request.id] = (big[idx].copy(), small[idx].copy())

    # -- after the window ----------------------------------------------------

    def free_program(self):
        self.bsk = self.ksk = None
        self.pool = None

    def check(self, requests) -> dict:
        """{name: (value, "<=" or ">=", limit)} over the checked rows of
        every answered request: words of the PBS output and of the
        keyswitched output unequal to the reference's, and PBS outputs
        whose integer under the big key is not the table's."""
        done = [r for r in requests if r.id in self.kept]
        big_bad = small_bad = wrong = 0
        n = self.p["polynomial_size"]
        polys = {op: torch.tensor(plain.as_signed(plain.test_polynomial(
                     self.tables[op], self.enc, self.enc, n)),
                     device=self.device) for op in {r.op for r in done}}
        if done:
            cts = _i64(np.concatenate([r.inputs["vector"].data[r.check_idx]
                                       for r in done]), self.device)
            per_row = torch.stack([polys[r.op] for r in done
                                   for _ in r.check_idx])
            want_big, want_small = plain.pbs_keyswitch(self.keys, self.p, cts,
                                                       per_row)
            got_big = _i64(np.concatenate([self.kept[r.id][0] for r in done]),
                           self.device)
            got_small = _i64(np.concatenate([self.kept[r.id][1]
                                             for r in done]), self.device)
            big_bad = int((got_big != want_big).sum())
            small_bad = int((got_small != want_small).sum())
            expect = torch.tensor(np.concatenate(
                [np.asarray(self.tables[r.op])[r.inputs["values"][r.check_idx]]
                 for r in done]), device=self.device)
            got_int = plain.decode_ints(self.keys, got_big, self.enc, True)
            wrong = int((got_int != expect).sum())
        rows = sum(len(r.check_idx) for r in done)
        return {"mismatched_pbs_words": (big_bad, "<=", 0),
                "mismatched_keyswitch_words": (small_bad, "<=", 0),
                "wrong_pbs_values": (wrong, "<=", 0),
                "rows_checked": (rows, ">=", 1)}


def _u64(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().view(np.uint64)


def _i64(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int64)).to(device)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)
