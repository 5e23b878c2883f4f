"""Time K7f and K7g, the dfs sweep's kernels (gpuspectral_tpu_torch/csrc/
dfs.cu), at variants of their design, on the sphere field.

    PYTHONPATH=. python3 tools/torch_dfs_variants.py variants [variant ...]
    PYTHONPATH=ROOT python3 tools/torch_dfs_variants.py ab

The timed work: K7f and K7g on chip_smoke.py's 65,536 random rays and the
262,144 primary rays of the 512x512 frame, each K7f call given the
attribute rows built once, as the wavefront gives them.

`variants` builds copies of dfs.cu, one change each from the shipped walk
(a warp a block of 32 rays, 4 warps a CTA, the node read as six strided
floats and two ints, each leaf cluster gated by the lane's own widened
slab test, the Woop loop unrolled by 4):

  warps1, warps2, warps8     1, 2 or 8 warps a CTA
  unroll2, unroll8           the Woop loop unrolled by 2 or 8
  noderows   a node read as one 32-byte row of two float4 [lo xyz, skip,
             hi xyz, leaf offset] (the int fields bit-cast), built here
             from the scene's (6, N) / (2, N) tables
  nogate     no gate on leaf clusters: a searching lane tests every slot
             of every non-empty cluster of an entered leaf
  leafmask   every cluster of an entered leaf slab-tested at once on the
             segment at the leaf's start, the warp's clusters the union of
             the lanes' masks (one __reduce_or_sync); a K7f lane whose best
             fell since re-tests a cluster before its slots
  prefetch   both successors of a node (ptr + 1 and its skip) loaded while
             the warp votes on it

Each variant goes to build/dfs_variants/<name>/ (one nvcc per variant, all
started together, with the flags of gpuspectral_tpu_torch/_build.py;
ptxas's registers and spills printed).  The tree's K7f / K7g are held to
their plain versions on the random rays, and each variant's outputs to the
tree's on both sets of rays.  Then every variant and the tree's own build
are timed with CUDA events, in order and again in reverse order.  One JSON
line.

`ab` times the port on PYTHONPATH (the tree's own build) and prints
checksums of the outputs, which no design of the kernels changes (two
trees print the same ones), and ptxas's lines of the dfs kernels.  To
compare two trees on one card, unpack the parent with `git archive` into
build/ and run this from the change's tree in one call, in the order
parent, change, change, parent.  Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import contextlib
import json
import pathlib
import sys

import torch
import torch_variants as tv

REPS = 10
ENTRY_POINTS = ("gst_dfs_closest", "gst_dfs_any")

_NODE = """__device__ __forceinline__ Node node(const Tree& T, int i) {
  const float* b = T.bounds;
  const int n = T.n_nodes;
  return {gst::v3(__ldg(b + i), __ldg(b + n + i), __ldg(b + 2 * n + i)),
          gst::v3(__ldg(b + 3 * n + i), __ldg(b + 4 * n + i), __ldg(b + 5 * n + i)),
          __ldg(T.meta + i), __ldg(T.meta + n + i)};
}"""
_NODE_ROWS = """__device__ __forceinline__ Node node(const Tree& T, int i) {
  const float4* row = reinterpret_cast<const float4*>(T.bounds) + 2 * i;
  const float4 a = __ldg(row), b = __ldg(row + 1);
  return {gst::xyz(a), gst::xyz(b), __float_as_int(a.w), __float_as_int(b.w)};
}"""
_GATE = "bool cin = go && cluster_entered(T, c, o, inv, lo, hi);"
_NO_GATE = "bool cin = go && !(__ldg(T.cmin + 3 * c) > __ldg(T.cmax + 3 * c));"
# leafmask: every cluster of an entered leaf slab-tested at once on the
# segment at the leaf's start (independent loads), the warp's union of the
# lanes' masks by one reduction; a K7f lane whose best fell since re-tests
# a cluster before its slots
_LEAF_LOOP = """  const int c1 = min((end + T.leaf_size - 1) / T.leaf_size, T.n_clusters);
  for (int c = off / T.leaf_size; c < c1 && __any_sync(kAll, go); ++c) {
    bool cin = go && cluster_entered(T, c, o, inv, lo, hi);
    if (!__any_sync(kAll, cin)) continue;"""
_LEAF_MASK = """  const int c0 = off / T.leaf_size;
  const int n = min((end + T.leaf_size - 1) / T.leaf_size, T.n_clusters) - c0;
  const float hi0 = hi;
  unsigned mine = 0;
#pragma unroll 8
  for (int j = 0; j < n; ++j)
    if (go && cluster_entered(T, c0 + j, o, inv, lo, hi0)) mine |= 1u << j;
  for (unsigned m = __reduce_or_sync(kAll, mine); m && __any_sync(kAll, go); m &= m - 1) {
    const int c = c0 + __ffs(m) - 1;
    bool cin = go && ((mine >> (c - c0)) & 1u) &&
               (hi == hi0 || cluster_entered(T, c, o, inv, lo, hi));
    if (!__any_sync(kAll, cin)) continue;"""


def _patched(*edits) -> dict:
    """{dfs.cu: its text with each (old, new, count) edit made}; raises
    unless `old` occurs exactly `count` times."""
    from gpuspectral_tpu_torch import _build

    text = (_build._CSRC / "dfs.cu").read_text()
    for old, new, count in edits:
        if text.count(old) != count:
            raise RuntimeError(f"csrc/dfs.cu holds {text.count(old)} copies of {old[:40]!r}")
        text = text.replace(old, new)
    return {"dfs.cu": text}


# prefetch: both successors of the node (ptr + 1 and its skip) loaded while
# the warp votes on it
_PREFETCH = (
    ("  while (ptr < T.n_nodes) {\n    const Node x = node(T, ptr);\n",
     "  Node x = node(T, 0);\n  while (ptr < T.n_nodes) {\n"
     "    const Node enter = node(T, min(ptr + 1, T.n_nodes - 1));\n"
     "    const Node jump = node(T, min(x.skip, T.n_nodes - 1));\n", 2),
    ("      ptr = x.skip;  // the same for every lane of the warp\n",
     "      ptr = x.skip;\n      x = jump;\n", 1),
    ("      ptr = x.skip;\n      continue;", "      ptr = x.skip;\n      x = jump;\n      continue;", 1),
    ("    ++ptr;\n    if (x.leaf < 0) continue;\n",
     "    ++ptr;\n    const int leaf = x.leaf;\n    x = enter;\n    if (leaf < 0) continue;\n", 2),
    ("(T, x.leaf, ", "(T, leaf, ", 2),
)


def variants() -> dict:
    """{name: {file name: text}} of every variant."""
    out = {f"warps{n}": tv.variant_sources(("dfs.cu",), dict(kWarps=str(n))) for n in (1, 2, 8)}
    out.update({f"unroll{n}": tv.variant_sources(("dfs.cu",), dict(kUnroll=str(n)))
                for n in (2, 8)})
    out["noderows"] = _patched((_NODE, _NODE_ROWS, 1))
    out["nogate"] = _patched((_GATE, _NO_GATE, 1))
    out["leafmask"] = _patched((_LEAF_LOOP, _LEAF_MASK, 1))
    out["prefetch"] = _patched(*_PREFETCH)
    return out


def node_rows(scene):
    """(N, 8) float32 rows [lo xyz, skip, hi xyz, leaf offset] of the
    scene's preorder tables, the int32 fields stored bit for bit."""
    bounds, meta = scene.bvh_dfs_bounds, scene.bvh_dfs_meta
    rows = torch.empty((bounds.shape[1], 8), dtype=torch.float32, device=bounds.device)
    rows[:, 0:3] = bounds[0:3].t()
    rows[:, 4:7] = bounds[3:6].t()
    bits = meta.contiguous().view(torch.float32)
    rows[:, 3], rows[:, 7] = bits[0], bits[1]
    return rows


@contextlib.contextmanager
def reading_node_rows():
    """While on, the dfs wrappers pass node_rows(scene) where the kernels
    take the (6, N) bounds (the noderows variant reads them so)."""
    from gpuspectral_tpu_torch.bvh import dfs_sweep as ds

    real = ds._launch_args
    built = {}

    def launch_args(scene):
        keep, args = real(scene)
        key = id(scene.bvh_dfs_bounds)
        if key not in built:  # once a scene, as the scene's own tables are
            built[key] = (scene.bvh_dfs_bounds, node_rows(scene))
        rows = built[key][1]
        return (*keep, rows), (rows.data_ptr(), *args[1:])

    ds._launch_args = launch_args
    try:
        yield
    finally:
        ds._launch_args = real


def calls(dev):
    """(the sphere field, its rays by name, {name: a no-argument call} of
    the timed work)."""
    from gpuspectral_tpu_torch.bvh import dfs_sweep as ds
    from gpuspectral_tpu_torch.bvh import ftb
    from gpuspectral_tpu_torch.scene.zoo import build_sphere_field

    field = build_sphere_field(dev)
    attr = ftb.attr_table(field)
    rays = dict(random=tv.chip_smoke.field_rays(tv.chip_smoke.K3_RAYS["parity"], field, 20, dev),
                primary=tv.chip_smoke.primary_rays(field, 512, dev))
    work = {}
    for tag, (o, d, lo, hi) in rays.items():
        work[f"k7f_{tag}"] = (lambda o=o, d=d, hi=hi: ds.dfs_closest(field, o, d, t_max=hi,
                                                                      attr=attr))
        work[f"k7g_{tag}"] = (lambda o=o, d=d, lo=lo, hi=hi: ds.dfs_any(field, o, d, lo, hi))
    return field, rays, work


def main_variants(names) -> int:
    from gpuspectral_tpu_torch.bvh import dfs_sweep as ds

    every = variants()
    names = names or list(every)
    dev = torch.device("cuda")
    smi = tv.card()
    print(smi, flush=True)
    libs = tv.build("dfs_variants", {n: every[n] for n in names}, ENTRY_POINTS,
                    show=lambda kern: "dfs" in kern)
    field, rays, work = calls(dev)
    ref = tv.results(work)
    o, d, lo, hi = rays["random"]
    plain = (list(ds.dfs_closest_ref(field, o, d, t_max=hi)), [ds.dfs_any_ref(field, o, d, lo, hi)])
    if not (tv.same(ref["k7f_random"], plain[0]) and tv.same(ref["k7g_random"], plain[1])):
        raise AssertionError("the tree's K7f / K7g differ from their plain versions")
    for name, lib in libs.items():
        with reading_node_rows() if name == "noderows" else contextlib.nullcontext():
            tv.check_builds({name: lib}, work, ref)  # raises on a difference
    builds = dict(libs, tree=None)
    times = {name: {key: [] for key in work} for name in builds}
    order = list(builds)
    for name in order + order[::-1]:
        rows = reading_node_rows() if name == "noderows" else contextlib.nullcontext()
        with tv.launching(builds[name]), rows:
            for key, fn in work.items():
                times[name][key].append(tv.chip_smoke.cuda_ms(fn, reps=REPS))
    print(json.dumps(dict(card=smi, rays={k: v[0].shape[0] for k, v in rays.items()},
                          ms=times)), flush=True)
    return 0


def main_ab() -> int:
    from gpuspectral_tpu_torch import _build

    dev = torch.device("cuda")
    smi = tv.card()
    _build.load()
    root = str(pathlib.Path(_build.__file__).resolve().parents[1])
    _, _, work = calls(dev)
    got = tv.results(work)
    ms = {name: tv.chip_smoke.cuda_ms(fn, reps=REPS) for name, fn in work.items()}
    print(json.dumps(dict(
        root=root, card=smi, ms=ms, outputs={k: tv.checksum(*v) for k, v in got.items()},
        ptxas={k: v for k, v in _build.build_info()["ptxas"].items() if "dfs" in k})),
        flush=True)
    return 0


if __name__ == "__main__":
    if not torch.cuda.is_available():
        print("torch_dfs_variants: no CUDA device", file=sys.stderr)
        sys.exit(1)
    mode = sys.argv[1] if len(sys.argv) > 1 else ""
    if mode not in ("ab", "variants"):
        print("usage: torch_dfs_variants.py ab | variants [variant ...]", file=sys.stderr)
        sys.exit(2)
    sys.exit(main_ab() if mode == "ab" else main_variants(sys.argv[2:]))
