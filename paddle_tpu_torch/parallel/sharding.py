"""Sharding rules: name-pattern -> partition spec for parameters, the
counterpart of the JAX package's ``parallel/sharding.py``.

A rule table is an ordered list of (regex, spec) pairs; first match wins
(the shape of the reference's AMP white/black lists, reference:
python/paddle/fluid/contrib/mixed_precision/fp16_lists.py). The JAX
package hands the specs to GSPMD as ``NamedSharding``s; the port keeps
the specs themselves (``PartitionSpec``, its own copy of
``jax.sharding.PartitionSpec``'s shape) and ``CompiledProgram`` places
each rank's shard by them (``compiler.py``). ``parallel/spec_layout.py``
is the canonical placement path; the pattern tables remain for explicit
layouts.
"""

import re

__all__ = ["PartitionSpec", "P", "MEGATRON_RULES", "match_spec",
           "check_spec", "known_slot_suffixes", "derive_shardings",
           "spec_axes", "shard_shape", "shard_of"]


class PartitionSpec(tuple):
    """One entry per dim: a mesh axis name, a tuple of names, or None
    (not sharded); trailing dims not named are not sharded."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


#: Megatron-style rules for the transformer naming convention of the
#: models: attention q/k/v and ffn-in weights are column-parallel (output
#: dim sharded on 'model'), attention-out and ffn-out weights row-parallel
#: (input dim sharded), their biases replicated so the psum epilogue stays
#: correct; embeddings shard the vocab dim.
MEGATRON_RULES = [
    (r"\.(q|k|v|ffn1)\.w$", P(None, "model")),
    (r"\.(q|k|v|ffn1)\.b$", P("model")),
    (r"\.(out|ffn2)\.w$", P("model", None)),
    (r"\.(out|ffn2)\.b$", P()),
    (r"word_emb|tok_emb", P("model", None)),
    (r".*", P()),
]


def match_spec(name, rules):
    for pat, spec in rules:
        if re.search(pat, name):
            return spec
    return P()


def _axis_sizes(mesh):
    return dict(zip(mesh.axis_names, mesh.shape))


def check_spec(shape, spec, mesh):
    """A spec is usable only if every named axis exists in the mesh and
    divides the corresponding dim; otherwise replicated."""
    sizes = _axis_sizes(mesh)
    if spec is None:
        return P()
    if len(spec) > len(shape):
        return P()  # over-long spec can't apply to this rank
    for dim, axes in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        if axes is None:
            continue
        axes = axes if isinstance(axes, tuple) else (axes,)
        total = 1
        for ax in axes:
            if ax not in sizes:
                return P()
            total *= sizes[ax]
        if dim % total != 0:
            return P()
    return P(*spec)


def known_slot_suffixes():
    """Accumulator slot names: the only suffixes that mark a var as an
    optimizer slot of its prefix parameter (``optimizer.py``'s
    ``ACCUMULATOR_SLOT_NAMES``)."""
    from paddle_tpu_torch.optimizer import ACCUMULATOR_SLOT_NAMES

    return frozenset(ACCUMULATOR_SLOT_NAMES)


_slot_re_cache = {}


def _slot_suffix_re():
    suffixes = known_slot_suffixes()
    cached = _slot_re_cache.get(suffixes)
    if cached is None:
        cached = re.compile(
            r"^(?:%s)(?:_\d+)?$" % "|".join(
                re.escape(s) for s in sorted(suffixes)
            )
        )
        _slot_re_cache[suffixes] = cached
    return cached


def _slot_parent(name, name_set):
    """Longest member of ``name_set`` that ``name`` extends as
    ``parent_<slot>[_<idx>]``, <slot> a known accumulator name: resolves
    accumulators to their parameter even when the parameter name ends in
    ``_0``, without capturing user vars that share a prefix."""
    slot_re = _slot_suffix_re()
    best = None
    for p in name_set:
        if p != name and name.startswith(p + "_"):
            if slot_re.match(name[len(p) + 1:]):
                if best is None or len(p) > len(best):
                    best = p
    return best


def derive_shardings(names, shapes, mesh, rules=None, overrides=None):
    """names -> spec: ``overrides`` (exact name -> spec) first, then the
    pattern ``rules``, checked against the mesh. Optimizer slots take
    their parameter's spec where no explicit rule names them; scalar
    slots fall back to replicated through ``check_spec``'s rank guard."""
    rules = rules if rules is not None else MEGATRON_RULES
    overrides = overrides or {}
    name_set = set(names)
    out = {}
    for name, shape in zip(names, shapes):
        spec = overrides.get(name)
        if spec is None:
            spec = match_spec(name, rules)
        if spec == P() and name not in overrides:
            parent = _slot_parent(name, name_set)
            if parent is not None:
                pspec = overrides.get(parent)
                if pspec is None:
                    pspec = match_spec(parent, rules)
                spec = pspec
        out[name] = check_spec(tuple(shape), spec, mesh)
    return out


def spec_axes(spec):
    """The mesh axes ``spec`` names."""
    out = set()
    for entry in tuple(spec or ()):
        if isinstance(entry, (list, tuple)):
            out.update(entry)
        elif entry is not None:
            out.add(entry)
    return out


def _dim_shards(entry, sizes, coords):
    """(number of shards, this rank's index) of a dim sharded over the
    axes of ``entry``, row-major over them."""
    axes = entry if isinstance(entry, (list, tuple)) else (entry,)
    n, i = 1, 0
    for a in axes:
        n, i = n * sizes[a], i * sizes[a] + coords[a]
    return n, i


def shard_shape(shape, spec, mesh):
    """The shape of one rank's shard of a ``shape`` value under ``spec``."""
    sizes = _axis_sizes(mesh)
    out = list(shape)
    for d, entry in enumerate(tuple(spec or ())):
        if entry is not None:
            out[d] //= _dim_shards(entry, sizes, dict.fromkeys(sizes, 0))[0]
    return tuple(out)


def shard_of(x, spec, mesh, coords=None):
    """The shard of the global value ``x`` (a tensor or numpy array) that
    the rank at ``coords`` (``{axis: index}``, default this rank's)
    holds under ``spec``: a view of ``x``."""
    sizes = _axis_sizes(mesh)
    coords = mesh.coords if coords is None else coords
    index = []
    for d, entry in enumerate(tuple(spec or ())):
        if entry is None:
            index.append(slice(None))
            continue
        n, i = _dim_shards(entry, sizes, coords)
        chunk = x.shape[d] // n
        index.append(slice(i * chunk, (i + 1) * chunk))
    return x[tuple(index)]
