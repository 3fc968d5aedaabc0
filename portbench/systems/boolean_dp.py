"""The system under test for configurations of "system": "boolean_dp": the
port's data-parallel gate front (concrete_tpu_torch.parallel.serve.
GateFront) over the configuration's "dp" ranks, one a card, rank 0 this
process on the first card; from host ciphertext arrays to results on the
host.

It is systems/boolean.py's System with the front in the ServerKey's place:
the same keys from the seed, inputs and check against the plain reference
(a dp deployment gives exactly the single card's words). Set-up makes the
keys, starts the ranks (the front replicates the standard-form keys and
each rank derives its evaluation forms) and warms every rank's graph at
the mix's tiers, which are rows a rank; free_program closes the front, so
that no rank is left, before the reference check.
"""

from __future__ import annotations

import time

# imported here, so that a program without the front fails at once
from concrete_tpu_torch.parallel.serve import GateFront

from ..plain import boolean as plain
from . import boolean


class System(boolean.System):

    def setup(self) -> dict:
        t0 = time.perf_counter()
        from concrete_tpu_torch.boolean import ServerKey
        from concrete_tpu_torch.dispersion import StandardDev
        from concrete_tpu_torch.params import BooleanParameters

        p = self.p
        self.keys = plain.make_keys(self.gen, p, self.device)
        boolean._sync(self.device)
        t1 = time.perf_counter()
        params = BooleanParameters(
            lwe_dimension=p["lwe_dimension"],
            glwe_dimension=p["glwe_dimension"],
            polynomial_size=p["polynomial_size"],
            lwe_modular_std_dev=StandardDev(p["lwe_modular_std_dev"]),
            glwe_modular_std_dev=StandardDev(p["glwe_modular_std_dev"]),
            pbs_base_log=p["pbs_base_log"], pbs_level=p["pbs_level"],
            ks_base_log=p["ks_base_log"], ks_level=p["ks_level"])
        key = ServerKey.from_arrays(
            boolean._u32(self.keys["bsk"]), boolean._u32(self.keys["ksk"]),
            params, device=self.device)
        self.server = GateFront(key, int(self.config["dp"]))
        t2 = time.perf_counter()
        self.warm()
        boolean._sync(self.device)
        return {"keys_s": t1 - t0, "ranks_s": t2 - t1,
                "warm_s": time.perf_counter() - t2}

    def free_program(self):
        if self.server is not None:
            self.server.close()
        super().free_program()
