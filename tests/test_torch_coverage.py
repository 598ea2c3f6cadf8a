"""The port covers the JAX package, read from source with ``ast`` (nothing
of JAX is imported; the Pallas check reads the port's kernel registry):

* every public top-level ``def``/``class`` of ``buffer_tpu/**/*.py``,
  ``scripts/*.py`` and ``bench.py`` is defined under the same name in the
  mirrored port module (``buffer_tpu/x/y.py`` -> ``buffer_tpu_torch/x/y.py``,
  ``scripts/z.py`` -> ``buffer_tpu_torch/scripts/z.py``, ``bench.py`` ->
  ``buffer_tpu_torch/bench.py``), or stands in RENAMED with the port name
  that serves it, or in NOT_PORTED with the reason ``ROADMAP.md`` queue 1
  gives;
* every function of ``buffer_tpu/kernels/*.py`` whose body calls
  ``pl.pallas_call`` maps to a CUDA kernel: a wrapper at one of
  ``kernels/sites.call_sites()`` with its plain version, a registered
  kernel whose ``replaces`` is the function's file and line, and its
  ``.cu`` source in ``buffer_tpu_torch/csrc/``.

An entry of a table that no longer matches the code (a JAX name that is
gone, a port name that is gone, a name the mirror now defines) fails as an
unmapped name does."""

import ast
import pathlib

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = "buffer_tpu_torch"

# JAX qualified name -> the port's qualified name that serves it
RENAMED = {
    "bench.py:synthetic_pair": "buffer_tpu_torch/data/synthetic.py:bench_pair",
    "buffer_tpu/compat/torch_convert.py:convert_state_dict":
        "buffer_tpu_torch/compat/from_jax.py:state_dict_to_variables",
    "buffer_tpu/compat/torch_convert.py:load_variables":
        "buffer_tpu_torch/compat/torch_convert.py:load_reference_model",
    "buffer_tpu/kernels/fps_pallas.py:fps_pallas":
        "buffer_tpu_torch/kernels/fps_cuda.py:fps_cuda_single",
    "buffer_tpu/kernels/fps_pallas.py:fps_pallas_batched":
        "buffer_tpu_torch/kernels/fps_cuda.py:fps_cuda_batched",
    "buffer_tpu/kernels/geom_pallas.py:ball_sample_planes_tpu":
        "buffer_tpu_torch/kernels/geom_cuda.py:ball_sample_planes_cuda",
    "buffer_tpu/kernels/geom_pallas.py:ball_sample_points_tpu":
        "buffer_tpu_torch/kernels/geom_cuda.py:ball_sample_points_cuda",
    "buffer_tpu/kernels/geom_pallas.py:banded_knn_tpu":
        "buffer_tpu_torch/kernels/knn_cuda.py:banded_knn_cuda",
    "buffer_tpu/kernels/geom_pallas.py:banded_nn1_tpu":
        "buffer_tpu_torch/kernels/knn_cuda.py:banded_nn1_cuda",
    "buffer_tpu/kernels/geom_pallas.py:banded_tpu_supported":
        "buffer_tpu_torch/kernels/knn_cuda.py:banded_supported",
    "buffer_tpu/kernels/geom_pallas.py:banded_win_rows":
        "buffer_tpu_torch/kernels/knn_cuda.py:banded_win_rows",
    "buffer_tpu/kernels/geom_pallas.py:nearest_tpu":
        "buffer_tpu_torch/kernels/geom_cuda.py:nearest_cuda",
    "buffer_tpu/kernels/geom_pallas.py:spt_pooled_tpu":
        "buffer_tpu_torch/kernels/geom_cuda.py:spt_pooled_cuda",
    "buffer_tpu/kernels/geom_pallas.py:topk_packed_tpu":
        "buffer_tpu_torch/kernels/knn_cuda.py:topk_keys_plain",
    "buffer_tpu/kernels/host.py:fps_host": "buffer_tpu_torch/data/host.py:fps_host",
    "buffer_tpu/kernels/host.py:knn_host": "buffer_tpu_torch/data/host.py:knn_host",
    "buffer_tpu/kernels/host.py:normals_host":
        "buffer_tpu_torch/data/host.py:normals_host",
    "buffer_tpu/kernels/host.py:radius_neighbors_host":
        "buffer_tpu_torch/data/host.py:radius_neighbors_host",
    "buffer_tpu/kernels/host.py:voxel_subsample_host":
        "buffer_tpu_torch/data/host.py:voxel_subsample_host",
    "buffer_tpu/models/point_learner.py:InvariantHead":
        "buffer_tpu_torch/nn/vn.py:InvariantHead",
    "buffer_tpu/nn/cylindrical.py:pad_cyl_3d":
        "buffer_tpu_torch/nn/cylindrical.py:pad_cyl_2d",
    "buffer_tpu/nn/vn.py:MaskedBatchNorm": "buffer_tpu_torch/nn/vn.py:batch_norm",
    "buffer_tpu/nn/vn.py:VNLinear": "buffer_tpu_torch/nn/vn.py:_linear_vn",
    "buffer_tpu/train/losses.py:jax_logsumexp":
        "buffer_tpu_torch/train/losses.py:_logsumexp",
    "scripts/analyze_trace.py:load_ops":
        "buffer_tpu_torch/scripts/analyze_trace.py:load_events",
    "scripts/dp_scaling.py:child": "buffer_tpu_torch/utils/dp_scaling.py:measure",
    "scripts/dp_scaling.py:main": "buffer_tpu_torch/utils/dp_scaling.py:main",
    "scripts/profile_micro.py:scan_time":
        "buffer_tpu_torch/utils/profiling.py:graph_time",
    "scripts/profile_stages.py:scan_time":
        "buffer_tpu_torch/utils/profiling.py:graph_time",
}

_FLAT = ("TPU layout path: the *Flat VN variants and their plane layout; the "
         "port's VN layers run [..., C, 3] tensors")
_GATHER = ("TPU layout path: bf16 pair-packed and plane gathers; the port uses "
           "plain fp32 gathers")
_OFFSETS = ("TPU-only offsets path behind pipeline/pyramid.py "
            "_use_offsets_path; the port takes normals_from_neighbors")
_BALL = ("the XLA ball sampling: the port's ball kernels and their plain "
         "versions serve it")

# JAX qualified name -> why the port has no counterpart (ROADMAP.md queue 1)
NOT_PORTED = {
    "buffer_tpu/models/patch_embedder.py:patch_planes_supported":
        "TPU layout path: the port's patches are [..., k, 3] tensors",
    "buffer_tpu/nn/vn.py:VNBatchNormFlat": _FLAT,
    "buffer_tpu/nn/vn.py:VNLinearLeakyReLUFlat": _FLAT,
    "buffer_tpu/nn/vn.py:VNStdFeatureFlat": _FLAT,
    "buffer_tpu/nn/vn.py:flatten_vn": _FLAT,
    "buffer_tpu/nn/vn.py:unflatten_vn": _FLAT,
    "buffer_tpu/nn/vn.py:vnn_block_planes": _FLAT,
    "buffer_tpu/nn/vn.py:std_perm": _FLAT,
    "buffer_tpu/nn/vn.py:VNLeakyReLU":
        "no caller in the JAX package; VNLinearLeakyReLU carries the gate",
    "buffer_tpu/nn/vn.py:mean_pool":
        "inlined: a mean over the neighbour axis in models/point_learner.py",
    "buffer_tpu/ops/neighbors.py:pairwise_sqdist":
        "inlined: the dense search and the fallbacks' windows compute "
        "|q|^2 - 2 q.s + |s|^2",
    "buffer_tpu/ops/neighbors.py:gather_points":
        "inlined: unbatched indexing; gather_rows is the batched gather",
    "buffer_tpu/ops/neighbors.py:ball_sample": _BALL,
    "buffer_tpu/ops/neighbors.py:ball_sample_chunked": _BALL,
    "buffer_tpu/ops/neighbors.py:gather_coord_feat_bf16": _GATHER,
    "buffer_tpu/ops/neighbors.py:gather_rows_bf16": _GATHER,
    "buffer_tpu/ops/neighbors.py:gather_rows_planes": _GATHER,
    "buffer_tpu/ops/normals.py:normals_from_offsets": _OFFSETS,
    "buffer_tpu/ops/normals.py:smallest_eigvec_sym3_components": _OFFSETS,
    "buffer_tpu/pipeline/pyramid.py:build_pyramid":
        "no caller in either package",
    "buffer_tpu/train/losses.py:jax_stop_grad":
        "JAX-only helper: Tensor.detach() serves it",
    "buffer_tpu/utils/cache.py:enable_compilation_cache":
        "the XLA compile cache",
    "buffer_tpu/utils/flags.py:exact_f32":
        "switches off TPU approximations that the port does not make",
}

KERNELS_DIR = "buffer_tpu/kernels"
# JAX function reaching pl.pallas_call -> (the wrapper at a call site of
# kernels/sites.call_sites(), the registered kernel, the JAX function
# whose file and line the kernel's ``replaces`` names)
PALLAS = {
    "buffer_tpu/kernels/fps_pallas.py:fps_pallas":
        ("fps_cuda_single", "fps_single", "fps_pallas"),
    "buffer_tpu/kernels/fps_pallas.py:fps_pallas_batched":
        ("fps_cuda_batched", "fps", "fps_pallas_batched"),
    "buffer_tpu/kernels/geom_pallas.py:ball_sample_points_tpu":
        ("ball_sample_points_cuda", "ball_sample_points",
         "ball_sample_points_tpu"),
    "buffer_tpu/kernels/geom_pallas.py:ball_sample_planes_tpu":
        ("ball_sample_planes_cuda", "ball_sample", "ball_sample_planes_tpu"),
    "buffer_tpu/kernels/geom_pallas.py:nearest_tpu":
        ("nearest_cuda", "nearest", "nearest_tpu"),
    "buffer_tpu/kernels/geom_pallas.py:spt_pooled_tpu":
        ("spt_pooled_cuda", "spt_pooled", "spt_pooled_tpu"),
    "buffer_tpu/kernels/geom_pallas.py:banded_knn_tpu":
        ("banded_knn_cuda", "bknn", "banded_knn_tpu"),
    # stage B of the banded kNN runs in the same launch as stage A
    "buffer_tpu/kernels/geom_pallas.py:topk_packed_tpu":
        ("banded_knn_cuda", "bknn", "banded_knn_tpu"),
    "buffer_tpu/kernels/geom_pallas.py:banded_nn1_tpu":
        ("banded_nn1_cuda", "bnn1", "banded_nn1_tpu"),
}
# stage B's own plain version, beside the fused wrapper's
STAGE_B_PLAIN = ("buffer_tpu/kernels/geom_pallas.py:topk_packed_tpu",
                 "buffer_tpu_torch/kernels/knn_cuda.py:topk_keys_plain")


def jax_modules():
    mods = sorted(p.relative_to(REPO).as_posix()
                  for p in (REPO / "buffer_tpu").rglob("*.py"))
    mods += sorted(f"scripts/{p.name}" for p in (REPO / "scripts").glob("*.py"))
    return mods + ["bench.py"]


def mirror(rel: str) -> str:
    if rel.startswith("buffer_tpu/"):
        return PORT + rel[len("buffer_tpu"):]
    return f"{PORT}/{rel}"          # scripts/z.py and bench.py


def top_level(source: str, public: bool = True) -> dict:
    """{name: first line} of the top-level defs and classes."""
    kinds = (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
    return {n.name: n.lineno for n in ast.parse(source).body
            if isinstance(n, kinds) and not (public and n.name.startswith("_"))}


def port_names(rel: str) -> set:
    """Every top-level def and class of a port file (none if it is not
    there)."""
    path = REPO / rel
    return set(top_level(path.read_text(), public=False)) if path.exists() else set()


def unmapped(rel: str, source: str, names_of=port_names) -> list:
    """What the tables and the mirror leave unexplained in JAX module
    ``rel`` (its ``source``), and the tables' stale entries for it."""
    names = top_level(source)
    mine = names_of(mirror(rel))
    problems = []
    for name in names:
        key = f"{rel}:{name}"
        listed = key in RENAMED or key in NOT_PORTED
        if name in mine:
            if listed:
                problems.append(f"{key}: {mirror(rel)} defines it; stale entry")
        elif key in RENAMED:
            path, target = RENAMED[key].split(":")
            if target not in names_of(path):
                problems.append(f"{key}: {RENAMED[key]} is gone")
        elif key not in NOT_PORTED:
            problems.append(f"{key}: no counterpart in {mirror(rel)}, "
                            "RENAMED or NOT_PORTED")
    for key in list(RENAMED) + list(NOT_PORTED):
        mod, name = key.split(":")
        if mod == rel and name not in names:
            problems.append(f"{key}: {rel} has no such name; stale entry")
    return problems


@pytest.mark.parametrize("rel", jax_modules())
def test_public_names_have_counterparts(rel):
    assert unmapped(rel, (REPO / rel).read_text()) == []


def test_tables_name_jax_modules():
    """Every entry names a module of the JAX package (a removed module
    leaves no stale entry behind)."""
    mods = set(jax_modules())
    keys = list(RENAMED) + list(NOT_PORTED) + list(PALLAS)
    assert [k for k in keys if k.split(":")[0] not in mods] == []
    assert not set(RENAMED) & set(NOT_PORTED)
    assert all(reason.strip() for reason in NOT_PORTED.values())


def test_checker_fails_on_an_unmapped_name():
    """A made-up module with one name the port serves and one it does not:
    the checker reports the second and nothing else."""
    src = ("def gather_rows(arr, idx):\n    return arr\n\n"
           "def made_up_search(q, s):\n    return q\n\n"
           "class _Private:\n    pass\n")
    rel = "buffer_tpu/ops/made_up.py"
    got = unmapped(rel, src, names_of=lambda path: {"gather_rows"})
    assert got == [f"{rel}:made_up_search: no counterpart in "
                   "buffer_tpu_torch/ops/made_up.py, RENAMED or NOT_PORTED"]


def pallas_functions(source: str) -> dict:
    """{name: (first line, pl.pallas_call sites)} of the top-level functions
    whose body calls ``pl.pallas_call``."""
    out = {}
    for node in ast.parse(source).body:
        if not isinstance(node, ast.FunctionDef):
            continue
        sites = sum(isinstance(c, ast.Call)
                    and isinstance(c.func, ast.Attribute)
                    and c.func.attr == "pallas_call"
                    and isinstance(c.func.value, ast.Name)
                    and c.func.value.id == "pl" for c in ast.walk(node))
        if sites:
            out[node.name] = (node.lineno, sites)
    return out


def kernel_problems(found: dict) -> list:
    """What stands between each Pallas function of ``found`` ({qualified
    name: (line, sites)}) and its CUDA kernel."""
    from buffer_tpu_torch.kernels import cuda, sites
    wrappers = {name: (getattr(mod, name), plain)
                for mod, name, plain in sites.call_sites()}
    problems = [f"{key}: not in PALLAS" for key in found if key not in PALLAS]
    problems += [f"{key}: no pl.pallas_call there; stale entry"
                 for key in PALLAS if key not in found]
    for key, (wrapper, kernel, replaced) in PALLAS.items():
        if key not in found:
            continue
        fn, plain = wrappers.get(wrapper, (None, None))
        if fn is None or not callable(plain) or not plain.__name__.endswith(
                "_plain"):
            problems.append(f"{key}: {wrapper} is no kernel call site with a "
                            "plain version")
        k = cuda.KERNELS.get(kernel)
        if k is None:
            problems.append(f"{key}: no registered kernel {kernel}")
            continue
        src = REPO / k.source
        if not (src.suffix == ".cu" and src.parent == REPO / PORT / "csrc"
                and src.exists()):
            problems.append(f"{key}: {k.source} is no CUDA source in csrc/")
        mod = key.split(":")[0]
        line = found.get(f"{mod}:{replaced}", (None,))[0]
        if k.replaces != f"{mod}:{line}":
            problems.append(f"{key}: kernel {kernel} replaces {k.replaces}, "
                            f"not {mod}:{line}")
    return problems


def test_every_pallas_call_has_a_cuda_kernel():
    found = {}
    for path in sorted((REPO / KERNELS_DIR).glob("*.py")):
        for name, where in pallas_functions(path.read_text()).items():
            found[f"{KERNELS_DIR}/{path.name}:{name}"] = where
    assert len(found) == 9 and sum(s for _, s in found.values()) == 10
    assert kernel_problems(found) == []
    key, plain = STAGE_B_PLAIN
    assert key in found
    path, name = plain.split(":")
    assert name in port_names(path)


def test_pallas_checker_fails_on_an_unmapped_kernel():
    """A made-up kernel module whose one function reaches
    ``pl.pallas_call``: the checker reports it."""
    src = ("def made_up_tpu(x):\n"
           "    return pl.pallas_call(kernel, grid=(1,))(x)\n\n"
           "def helper(x):\n    return x\n")
    found = {f"{KERNELS_DIR}/made_up.py:{n}": w
             for n, w in pallas_functions(src).items()}
    assert found == {f"{KERNELS_DIR}/made_up.py:made_up_tpu": (1, 1)}
    problems = kernel_problems(found)
    assert f"{KERNELS_DIR}/made_up.py:made_up_tpu: not in PALLAS" in problems
