"""Canonical sharding layer: the parameter-role partition-spec registry,
the counterpart of the JAX package's ``parallel/spec_layout.py``.

Every parameter gets a role-derived ``PartitionSpec``, so nothing stays
replicated by omission: **roles** (embedding, column, row, bias_column,
bias_row, norm_scale, norm_bias, scalar) with a canonical spec chain each,
fitted axis by axis against the mesh; **role inference** from the
program IR (op type, then the structure around a matmul — one feeding a
``c_allreduce`` is row-parallel, the Megatron epilogue — then the var
name, then the shape), walking ``pipeline_stack`` sub-blocks with their
per-layer views mapped back to the stacked parameters; optimizer slots
inherit their parent's spec; and **identity**, ``fingerprint()``, a
content hash of the role table and the overrides. The JAX package hands
the specs to GSPMD; ``CompiledProgram`` (``compiler.py``) places each
rank's shard by them.

Mesh axes are matched by NAME: the tp axis is 'model' or 'tp', the ZeRO
axis 'fsdp', data parallel 'data'/'dp'/'batch'. On a pure data-parallel
mesh every spec collapses to replicated.
"""

import hashlib
import json
import re

from paddle_tpu_torch.observability.logger import RateLimitedLogger
from paddle_tpu_torch.parallel.sharding import P, _slot_parent, check_spec

__all__ = ["SpecLayout", "Role", "infer_roles"]

#: mesh-axis name aliases, checked in order
TP_AXIS_NAMES = ("model", "tp")
FSDP_AXIS_NAMES = ("fsdp",)
DATA_AXIS_NAMES = ("data", "dp", "batch")
EP_AXIS_NAMES = ("ep", "expert")

#: the axes that make a mesh "tensor-sharded" for parameter placement —
#: the static sharding analyzer (analysis/sharding.py) and the
#: spec_layout auto-default gate (compiler.py) both key off this set, so
#: a new tp-axis alias added here flows to both
TENSOR_AXIS_NAMES = TP_AXIS_NAMES + FSDP_AXIS_NAMES


def tensor_parallel_axes(axis_sizes):
    """Mesh axes (from a {name: size} map) that tensor-shard parameters:
    tp/fsdp aliases with size > 1. Empty on pure dp/seq/ep/stage meshes —
    the registry is a no-op there and placement machinery can skip it."""
    return [a for a in axis_sizes
            if a in TENSOR_AXIS_NAMES and axis_sizes[a] > 1]


class Role:
    """Closed set of parameter roles. String constants (not an Enum) so a
    role travels through JSON fingerprints and test asserts unchanged."""

    EMBEDDING = "embedding"       # [vocab, hidden] lookup tables
    COLUMN = "column"             # [in, out], output dim tensor-sharded
    ROW = "row"                   # [in, out], input dim tensor-sharded
    BIAS_COLUMN = "bias_column"   # [out] bias of a column-parallel matmul
    BIAS_ROW = "bias_row"         # [out] bias of a row-parallel matmul
    NORM_SCALE = "norm_scale"     # layer/batch-norm scale
    NORM_BIAS = "norm_bias"       # layer/batch-norm shift
    SCALAR = "scalar"             # rank-0/1-of-1 state (beta pows, steps)
    REPLICATED = "replicated"     # the unknown-role fallback
    #: hot-cache slab of a sharded embedding table (embedding/store.py):
    #: hash-partitioned rows, canonical placement P('ep', None)
    EMBEDDING_SHARD = "embedding_shard"

    ALL = (EMBEDDING, COLUMN, ROW, BIAS_COLUMN, BIAS_ROW, NORM_SCALE,
           NORM_BIAS, SCALAR, REPLICATED, EMBEDDING_SHARD)


#: name conventions for column- vs row-parallel dense weights (the
#: models/ and reference-transformer naming); matched as a *hint* after
#: op-type and IR-structure evidence
_COLUMN_NAME_RE = re.compile(
    r"(\.|^)(q|k|v|query|key|value|qkv|ffn1|fc1|up|gate|in_proj)\.(w|b)"
)
# NOTE the boundary is a DOT, not '_': head params like 'mlm_out.w'
# ('<task>_out' naming) are vocab projections — expanding matmuls whose
# right layout is column (shard the vocab dim), decided by the shape rule
_ROW_NAME_RE = re.compile(
    r"(\.|^)(out|ffn2|fc2|down|out_proj|proj_out)\.(w|b)"
)
_EMB_NAME_RE = re.compile(r"(word|pos|tok|type|sent)[a-z_]*emb|embedding|^w[tp]e$")

#: ops whose weight input is an embedding table, and the slot it rides in
_LOOKUP_OPS = {"lookup_table_v2": "W", "lookup_table": "W"}

#: ops that normalize with Scale/Bias parameter slots
_NORM_OPS = ("layer_norm", "batch_norm", "data_norm", "instance_norm",
             "group_norm")

_unknown_role_log = RateLimitedLogger("paddle_tpu_torch.spec_layout", max_records=8)
_warned_unknown = set()


def _axis_in(mesh_axes, names):
    for n in names:
        if n in mesh_axes:
            return n
    return None


# ---------------------------------------------------------------------------
# role inference from the program IR
# ---------------------------------------------------------------------------


def _param_names(program):
    out = set()
    for block in program.blocks:
        for v in block.vars.values():
            if getattr(v, "persistable", False):
                out.add(v.name)
    # Parameters proper (all_parameters) are persistable; optimizer slots
    # are persistable too and resolved via slot inheritance later
    return out


def _stacked_param_map(op):
    """pipeline_stack: the op records the exact inner-view -> stacked
    parent mapping (layers/pipeline.py: 'StackedParams' input zipped with
    the 'param_inner_vars' attr; storage has a leading stage dim)."""
    inner = op.attr("param_inner_vars") or []
    stacked = op.input("StackedParams")
    return dict(zip(inner, stacked))


def stacked_param_names(program):
    """Names of parameters stored stacked [num_layers, *shape] by a
    pipeline_stack op — their role specs apply to the per-layer dims."""
    out = set()
    for block in program.blocks:
        for op in block.ops:
            if op.type == "pipeline_stack":
                out.update(op.input("StackedParams"))
    return out


def infer_roles(program):
    """{param_name: Role} for every *parameter* (not slots) the program's
    ops touch. Pure IR analysis — op type + structure + var name + shape;
    no scope or mesh needed."""
    params = {p.name: p for p in program.all_parameters()}
    roles = {}

    def note(name, role, *, stacked=False):
        # FIRST classification wins (setdefault): weight_role already
        # orders its evidence structural -> name -> shape per op, and a
        # param's first consumer sees the producer context the later
        # ones lack
        if name not in params and not stacked:
            return
        roles.setdefault(name, role)

    def classify_block(block, view_to_stacked=None, consumers=None):
        # map: output var name -> producing op (this block only)
        producer = {}
        for op in block.ops:
            for outs in op.outputs.values():
                for n in outs:
                    producer[n] = op
        # consumers: var name -> [op] (for the c_allreduce row signal)
        cons = {}
        for op in block.ops:
            for ins in op.inputs.values():
                for n in ins:
                    cons.setdefault(n, []).append(op)

        def resolve(name):
            """Sub-block per-layer views resolve to their stacked parent
            (role applies to the parent; its shape has a leading stage
            dim the spec fitter skips via the stacked marker)."""
            if view_to_stacked and name in view_to_stacked:
                return view_to_stacked[name]
            return name

        def is_param(name):
            return resolve(name) in params or (
                view_to_stacked and name in view_to_stacked
            )

        def weight_role(op, wname, out_name):
            """column vs row for a dense weight: IR structure first, then
            the naming convention, then shape."""
            # 1. structural: the Megatron row-parallel epilogue is an
            #    all-reduce over the tp ring right after the matmul
            seen, frontier = set(), [out_name]
            for _ in range(3):  # follow elementwise chains a few hops
                nxt = []
                for n in frontier:
                    for c in cons.get(n, ()):
                        if c.type.startswith("c_allreduce"):
                            return Role.ROW
                        if c.type in ("elementwise_add", "scale", "cast",
                                      "dropout", "gelu", "relu"):
                            for outs in c.outputs.values():
                                for o in outs:
                                    if o not in seen:
                                        seen.add(o)
                                        nxt.append(o)
                frontier = nxt
            # 2. structural: consuming the (possibly activated) output of a
            #    column-parallel matmul means the contraction dim is
            #    tensor-sharded -> row-parallel
            x_names = [n for slot in ("X",) for n in op.input(slot)]
            hops = 0
            while x_names and hops < 4:
                hops += 1
                src = producer.get(x_names[0])
                if src is None:
                    break
                if src.type in ("mul", "matmul", "matmul_v2"):
                    for wn in src.input("Y"):
                        if roles.get(resolve(wn)) == Role.COLUMN:
                            return Role.ROW
                    break
                if src.type in ("gelu", "relu", "elementwise_add", "scale",
                                "dropout", "cast"):
                    x_names = [n for n in src.input("X")]
                    continue
                break
            # 3. the naming convention
            if _ROW_NAME_RE.search(wname):
                return Role.ROW
            if _COLUMN_NAME_RE.search(wname):
                return Role.COLUMN
            # 4. shape: expansion -> column, contraction -> row; square
            #    defaults to column (the safe choice: forward needs no
            #    collective, the epilogue all-reduce is GSPMD's call)
            v = params.get(resolve(wname))
            shape = tuple(v.shape or ()) if v is not None else ()
            if view_to_stacked and wname in view_to_stacked and len(shape) >= 3:
                shape = shape[1:]  # drop the stacked stage dim
            if len(shape) == 2 and shape[0] > shape[1]:
                return Role.ROW
            return Role.COLUMN

        for op in block.ops:
            t = op.type
            if t in _LOOKUP_OPS:
                for n in op.input(_LOOKUP_OPS[t]):
                    if is_param(n):
                        note(resolve(n), Role.EMBEDDING, stacked=True)
            elif t in ("sharded_embedding_lookup", "sharded_embedding_sgd"):
                # the engine's hot-cache slab: rows hash-partitioned over
                # the ep axis (embedding/table.py hash_shard)
                for n in op.input("Table"):
                    if is_param(n):
                        note(resolve(n), Role.EMBEDDING_SHARD, stacked=True)
            elif t in _NORM_OPS:
                for n in op.input("Scale"):
                    if is_param(n):
                        note(resolve(n), Role.NORM_SCALE, stacked=True)
                for n in op.input("Bias"):
                    if is_param(n):
                        note(resolve(n), Role.NORM_BIAS, stacked=True)
            elif t in ("mul", "matmul", "matmul_v2"):
                outs = op.output("Out")
                out_name = outs[0] if outs else None
                for n in op.input("Y"):
                    if is_param(n):
                        r = resolve(n)
                        if _EMB_NAME_RE.search(r):
                            note(r, Role.EMBEDDING, stacked=True)
                        else:
                            note(r, weight_role(op, n, out_name),
                                 stacked=True)
                # transposed tied-embedding heads: matmul(x, word_emb^T)
                for n in op.input("X"):
                    if is_param(n) and _EMB_NAME_RE.search(resolve(n)):
                        note(resolve(n), Role.EMBEDDING, stacked=True)
            elif t in ("elementwise_add", "elementwise_mul"):
                # rank-1 parameter operand: a bias or a hand-built norm
                # scale (models/gpt_ir builds layer norm from elementwise
                # ops). Column/row follows the producing matmul's weight.
                for n in op.input("Y") + op.input("X"):
                    if not is_param(n):
                        continue
                    r = resolve(n)
                    v = params.get(r)
                    shape = tuple(v.shape or ()) if v is not None else ()
                    eff_rank = len(shape)
                    if view_to_stacked and n in view_to_stacked:
                        eff_rank -= 1  # stacked stage dim
                    if eff_rank != 1:
                        continue
                    if t == "elementwise_mul":
                        note(r, Role.NORM_SCALE, stacked=True)
                        continue
                    src_names = op.input("X") if n in op.input("Y") \
                        else op.input("Y")
                    src = producer.get(src_names[0]) if src_names else None
                    hops = 0
                    while src is not None and hops < 4 and src.type in (
                            "gelu", "relu", "scale", "cast", "dropout"):
                        hops += 1
                        xs = src.input("X")
                        src = producer.get(xs[0]) if xs else None
                    role = Role.NORM_BIAS
                    if src is not None and src.type in ("mul", "matmul",
                                                        "matmul_v2"):
                        wr = None
                        for wn in src.input("Y"):
                            wr = roles.get(resolve(wn))
                        role = (Role.BIAS_COLUMN if wr == Role.COLUMN
                                else Role.BIAS_ROW)
                    elif src is not None and src.type.startswith(
                            "c_allreduce"):
                        role = Role.BIAS_ROW
                    note(r, role, stacked=True)

        # descend into pipeline_stack sub-blocks with the view mapping
        for op in block.ops:
            if op.type == "pipeline_stack":
                idx = op.attr("sub_block")
                if idx is None or idx >= len(program.blocks):
                    continue
                sub = program.blocks[idx]
                classify_block(sub, view_to_stacked=_stacked_param_map(op))

    classify_block(program.global_block())

    # scalar-ish parameters the ops never classified (rank 0/1 tiny state
    # like learning-rate vars) — explicit scalar role, not "unknown"
    for name, v in params.items():
        if name in roles:
            continue
        shape = tuple(v.shape or ())
        if len(shape) == 0 or (len(shape) == 1 and int(shape[0]) <= 1):
            roles[name] = Role.SCALAR
    return roles


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------

#: canonical spec chains per role, written against LOGICAL axis slots
#: ("fsdp"/"tp" placeholders resolved to the mesh's real axis names).
#: Each entry is tried in order; the first that fits the shape+mesh wins.
_DEFAULT_ROLE_SPECS = {
    # shard the vocab dim over fsdp x tp (the snippet-[2] shape); a vocab
    # the product cannot divide falls back to sharding the hidden dim
    Role.EMBEDDING: [P(("fsdp", "tp"), None), P("tp", None), P("fsdp", None),
                     P(None, "tp")],
    # column-parallel: output dim on tp, input dim ZeRO-sliced on fsdp;
    # degrade toward sharding whichever dim divides
    Role.COLUMN: [P("fsdp", "tp"), P(None, "tp"), P("tp", None),
                  P("fsdp", None)],
    # row-parallel: input dim on tp (the Megatron contraction), output
    # dim ZeRO-sliced on fsdp
    Role.ROW: [P("tp", "fsdp"), P("tp", None), P(None, "tp"),
               P("fsdp", None)],
    # hot-cache slab: rows live on their hash-owner ep shard; a mesh
    # without an ep axis (or an indivisible capacity) replicates
    Role.EMBEDDING_SHARD: [P("ep", None)],
    Role.BIAS_COLUMN: [P("tp")],
    Role.BIAS_ROW: [P("fsdp"), P()],
    Role.NORM_SCALE: [P()],
    Role.NORM_BIAS: [P()],
    Role.SCALAR: [P()],
    Role.REPLICATED: [P()],
}


def _spec_to_jsonable(spec):
    out = []
    for e in tuple(spec):
        if e is None:
            out.append(None)
        elif isinstance(e, tuple):
            out.append(list(e))
        else:
            out.append(str(e))
    return out


class SpecLayout:
    """Registry of canonical PartitionSpecs per parameter role.

        layout = SpecLayout()                        # default role table
        layout.override("word_embedding", P(None, "model"))
        shardings = layout.derive_shardings(program, names, shapes, mesh)

    ``set_role_spec`` edits a role's canonical chain (the documented way
    to re-layout a whole family at once); ``override`` pins one var.
    Both change ``fingerprint()``, which the compile cache folds into the
    program fingerprint — editing the layout forces a retrace, an
    identical layout hits cached entries (including cross-process).
    """

    LAYOUT_FORMAT = 1

    def __init__(self, role_specs=None, overrides=None):
        self._role_specs = {
            role: list(chain) for role, chain in _DEFAULT_ROLE_SPECS.items()
        }
        if role_specs:
            for role, chain in role_specs.items():
                self.set_role_spec(role, chain)
        self._overrides = dict(overrides or {})
        self._role_cache = {}   # (program uid, version) -> roles dict

    # -- registry editing ------------------------------------------------
    def set_role_spec(self, role, chain):
        """Replace a role's canonical spec chain. ``chain`` is one
        PartitionSpec or a list tried in fit order."""
        if role not in Role.ALL:
            raise ValueError(
                f"unknown role {role!r}; roles are {Role.ALL}"
            )
        if isinstance(chain, P) or chain is None:
            chain = [chain if chain is not None else P()]
        self._role_specs[role] = [P(*tuple(s)) for s in chain]
        return self

    def override(self, name, spec):
        """Pin one variable to an exact spec (wins over role inference)."""
        self._overrides[name] = P(*tuple(spec)) if spec is not None else P()
        return self

    @property
    def overrides(self):
        return dict(self._overrides)

    # -- identity ---------------------------------------------------------
    def fingerprint(self):
        """Content hash of the layout: role table + overrides + format.
        Pure function of the registry's CONTENT, so two processes with
        the same layout produce the same compile-cache fingerprint."""
        payload = {
            "format": self.LAYOUT_FORMAT,
            "roles": {
                role: [_spec_to_jsonable(s) for s in chain]
                for role, chain in sorted(self._role_specs.items())
            },
            "overrides": {
                n: _spec_to_jsonable(s)
                for n, s in sorted(self._overrides.items())
            },
        }
        return hashlib.sha256(
            json.dumps(payload, sort_keys=True).encode("utf-8")
        ).hexdigest()

    # -- resolution -------------------------------------------------------
    def roles_for(self, program):
        """Memoized infer_roles per program version."""
        key = (program._uid, program._version)
        roles = self._role_cache.get(key)
        if roles is None:
            if len(self._role_cache) > 64:
                self._role_cache.clear()
            roles = infer_roles(program)
            self._role_cache[key] = roles
        return roles

    def _resolve_axes(self, mesh):
        axes = dict(zip(mesh.axis_names, mesh.shape))
        return {
            "tp": _axis_in(axes, TP_AXIS_NAMES),
            "fsdp": _axis_in(axes, FSDP_AXIS_NAMES),
            "data": _axis_in(axes, DATA_AXIS_NAMES),
            "ep": _axis_in(axes, EP_AXIS_NAMES),
        }, axes

    def _fit(self, chain, shape, mesh):
        """First spec in the chain that applies to shape on mesh, with
        per-dim graceful degradation: a named axis that is absent from
        the mesh or does not divide its dim is dropped from that dim
        (not the whole spec). Logical 'fsdp'/'tp' slots resolve to the
        mesh's real axis names first."""
        logical, sizes = self._resolve_axes(mesh)
        for spec in chain:
            fitted = []
            for dim, entry in zip(
                shape, tuple(spec) + (None,) * (len(shape) - len(spec))
            ):
                if entry is None:
                    fitted.append(None)
                    continue
                req = entry if isinstance(entry, tuple) else (entry,)
                kept = []
                total = 1
                for ax in req:
                    real = logical.get(ax, ax)  # logical slot or real name
                    if real is None or real not in sizes:
                        continue
                    if dim % (total * sizes[real]) == 0:
                        kept.append(real)
                        total *= sizes[real]
                if kept:
                    fitted.append(tuple(kept) if len(kept) > 1 else kept[0])
                else:
                    fitted.append(None)
            if len(spec) > len(shape):
                fitted = []  # over-long spec cannot apply to this rank
            if any(e is not None for e in fitted):
                while fitted and fitted[-1] is None:
                    fitted.pop()
                return P(*fitted)
        return P()

    def spec_for(self, name, shape, role, mesh, *, stacked=False):
        """Resolved PartitionSpec for one var. ``stacked=True`` marks a
        pipeline-stacked parameter [num_layers, *shape]: the role spec
        applies to the per-layer dims, the stage dim stays unsharded here
        (pipeline placement is the stack's own business, provided through
        overrides)."""
        if name in self._overrides:
            return check_spec(tuple(shape), self._overrides[name], mesh)
        chain = self._role_specs.get(role or Role.REPLICATED,
                                     self._role_specs[Role.REPLICATED])
        if stacked and len(shape) >= 1:
            inner = self._fit(chain, tuple(shape)[1:], mesh)
            return P(None, *tuple(inner)) if len(inner) else P()
        return self._fit(chain, tuple(shape), mesh)

    def derive_shardings(self, program, names, shapes, mesh,
                         overrides=None):
        """names -> spec for a step's scope inputs: overrides
        first (``overrides`` is a caller-supplied exact name -> spec map
        layered over the registry's own, e.g. a PipelinedStack's stage
        placement), then role-derived canonical specs, optimizer slots
        inheriting their parent parameter's resolved spec (ZeRO-style:
        the slot is sliced along every axis its parent is, fsdp
        included). Unknown-role parameters warn once through the
        rate-limited logger and fall back to replicated."""
        all_overrides = dict(self._overrides)
        if overrides:
            all_overrides.update(overrides)
        roles = self.roles_for(program)
        params = {p.name for p in program.all_parameters()}
        stacked_names = stacked_param_names(program)
        name_set = set(names)
        specs = {}
        for name, shape in zip(names, shapes):
            shape = tuple(shape)
            if name in all_overrides:
                specs[name] = check_spec(shape, all_overrides[name], mesh)
                continue
            role = roles.get(name)
            target = name
            if role is None:
                parent = _slot_parent(name, name_set)
                if parent is not None:
                    if parent in all_overrides:
                        # slots of an overridden parameter inherit it
                        specs[name] = check_spec(
                            shape, all_overrides[parent], mesh)
                        continue
                    role = roles.get(parent)
                    target = parent
            if role is None:
                if len(shape) <= 1:
                    role = Role.SCALAR
                else:
                    if name in params and name not in _warned_unknown:
                        _warned_unknown.add(name)
                        _unknown_role_log.warning(
                            "spec_layout: no role inferred for parameter "
                            "%r (shape %s); falling back to replicated — "
                            "pin it with SpecLayout.override()",
                            name, shape,
                        )
                    role = Role.REPLICATED
            spec = self.spec_for(
                target, shape, role, mesh,
                stacked=(target in stacked_names),
            )
            specs[name] = spec
        return specs


def reset_unknown_role_warnings():
    """Test hook: re-arm the once-per-name unknown-role warning."""
    _warned_unknown.clear()
