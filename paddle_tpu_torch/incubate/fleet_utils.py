"""FleetUtil: production train/infer helpers.

reference: python/paddle/fluid/incubate/fleet/utils/fleet_util.py:40 —
rank-0 logging, global AUC from the distributed metric states, program
introspection, model save/compare helpers. The port's copy of the JAX
package's ``incubate/fleet_utils.py``: metric states are in-scope tensors
(the ``auc`` op's accumulators); cross-worker reduction goes through the
PS barrier/dense tables or is single-host.
"""

import os

import numpy as np

from paddle_tpu_torch.core.scope import global_scope
from paddle_tpu_torch.io import to_host

__all__ = ["FleetUtil"]


class FleetUtil:
    def __init__(self, fleet=None):
        self._fleet = fleet

    # -- logging --------------------------------------------------------
    def rank0_print(self, *args, **kwargs):
        """reference: fleet_util.py rank0_print."""
        if self._rank() == 0:
            print(*args, **kwargs, flush=True)

    def rank0_error(self, *args):
        if self._rank() == 0:
            import logging

            logging.getLogger("paddle_tpu_torch.fleet").error(" ".join(map(str, args)))

    def _rank(self):
        if self._fleet is not None:
            try:
                return self._fleet.worker_index()
            except Exception:
                pass
        return int(os.environ.get("PADDLE_TRAINER_ID", "0"))

    # -- metrics --------------------------------------------------------
    def get_global_auc(self, stat_pos, stat_neg, scope=None):
        """AUC from the in-graph auc op's positive/negative histogram
        accumulators (reference: fleet_util.py get_global_auc — there the
        stats all-reduce over workers first; here the single-host form, the
        multi-worker sum arriving via the PS dense table when used in a
        fleet)."""
        scope = scope or global_scope()
        stat_pos = stat_pos if isinstance(stat_pos, str) else stat_pos.name
        stat_neg = stat_neg if isinstance(stat_neg, str) else stat_neg.name
        pos = scope.find_var(stat_pos)
        neg = scope.find_var(stat_neg)
        if pos is None or neg is None:
            return None
        pos = to_host(pos).astype(np.float64).reshape(-1)
        neg = to_host(neg).astype(np.float64).reshape(-1)
        # histogram walk, high threshold -> low
        tp = fp = 0.0
        area = 0.0
        for i in range(len(pos) - 1, -1, -1):
            new_tp = tp + pos[i]
            new_fp = fp + neg[i]
            area += (new_fp - fp) * (tp + new_tp) / 2.0
            tp, fp = new_tp, new_fp
        if tp == 0 or fp == 0:
            return 0.5
        return float(area / (tp * fp))

    # -- program introspection -------------------------------------------
    def program_summary(self, program):
        """Op/param census (reference: fleet_util.py's program_type_trans +
        print helpers, condensed)."""
        block = program.global_block()
        op_counts = {}
        for op in block.ops:
            op_counts[op.type] = op_counts.get(op.type, 0) + 1
        params = program.all_parameters()
        n_elems = int(sum(int(np.prod(p.shape or [0])) for p in params))
        return {
            "num_ops": len(block.ops),
            "op_counts": dict(sorted(op_counts.items())),
            "num_params": len(params),
            "param_elements": n_elems,
        }

    def print_program_summary(self, program):
        s = self.program_summary(program)
        self.rank0_print(
            f"program: {s['num_ops']} ops, {s['num_params']} params "
            f"({s['param_elements']:,} elements)"
        )
        return s

    # -- model compare ----------------------------------------------------
    def params_allclose(self, program, dirname, rtol=1e-5, atol=1e-8,
                        scope=None):
        """Compare in-scope params with a save_persistables directory
        (reference: fleet_util.py check_two_programs-style model compare).
        Returns {param: max_abs_diff} for mismatches (empty = equal)."""
        scope = scope or global_scope()
        state = {}
        for fn in os.listdir(dirname):
            if fn.endswith(".npy"):
                state[fn[:-4]] = np.load(os.path.join(dirname, fn))
        bad = {}
        for p in program.all_parameters():
            cur = to_host(scope.find_var(p.name))
            ref = state.get(p.name.replace("/", "_"))
            if ref is None:
                bad[p.name] = float("inf")
            elif not np.allclose(cur, ref, rtol=rtol, atol=atol):
                bad[p.name] = float(np.abs(cur - ref).max())
        return bad

    # -- persistence glue -------------------------------------------------
    def save_program(self, program, dirname, executor=None, scope=None):
        from paddle_tpu_torch import io as pio

        pio.save_persistables(executor, dirname, main_program=program)

    def load_program(self, program, dirname, executor=None):
        from paddle_tpu_torch import io as pio

        pio.load_persistables(executor, dirname, main_program=program)
