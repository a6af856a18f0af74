"""The chip tools' source-reading parts, on the CPU: kernel_ab.py's
knock-outs must each find their text in the CUDA source exactly once (or the
tool would time an unchanged copy), and chip_smoke.py's tensor-core check
must name every instance of the forward body (`causal_flat_kernel`) and of
the backward bodies (`causal_dq_kernel`, `causal_dkv_kernel`) from its
mangled name."""

import re

import pytest

import chip_smoke
import kernel_ab


def test_knockouts_apply_to_the_source(tmp_path, monkeypatch):
    monkeypatch.setattr(kernel_ab, "BUILD", tmp_path)
    sources = kernel_ab.knockout_sources()
    original = kernel_ab.SOURCE.read_text()
    assert set(sources) == {f"ko-{n}" for n in kernel_ab.KNOCKOUTS}
    for name, (path, include) in sources.items():
        text = path.read_text()
        assert text != original, name
        for old, _ in kernel_ab.KNOCKOUTS[name[3:]]:
            assert old not in text, (name, old)
        assert include == kernel_ab.SOURCE.parent


def _widths():
    """The head widths `sea::dispatch` (csrc/sea_mask.cuh) instantiates."""
    header = (kernel_ab.SOURCE.parent / "sea_mask.cuh").read_text()
    return sorted(set(re.findall(r"std::integral_constant<int, (\d+)>", header)))


# a launch's template arguments as the sources spell them: an explicit width
# and type, or the dispatched ones (every width of `_widths`, both types)
DISPATCHED = "decltype(d)::value, typename decltype(t)::type"
MANGLED_T = {"float": "f", "__nv_bfloat16": "13__nv_bfloat16"}


def _instances(width_type: str):
    """[(width, type)] of one launch's first template arguments."""
    if width_type == DISPATCHED:
        return [(d, t) for d in _widths() for t in MANGLED_T]
    d, t = width_type.split(", ")
    return [(d, t)]


def test_tensor_core_check_names_every_instance():
    """The instances the entry points launch, as nvcc mangles them
    (`causal_flat_kernel<D, T, STATS, BIDIR, IMPL>` in an anonymous
    namespace), map onto the kernel ids and widths the check requires."""
    names = set()
    for mangled in _forward_mangled():
        assert chip_smoke.FLAT_INSTANCE.search(mangled), mangled
        names.add(chip_smoke.instance_name(mangled))
    assert _widths() == ["64", "80"]
    assert names == {f"{kid} {t} D{d}" for t in ("float32", "bfloat16") for kid, d in (
        ("K1", 64), ("K2/K6", 64), ("K5", 64), ("K9a", 64), ("K9b", 64), ("K9c", 64),
        ("K1", 80), ("K2", 80))}


def _forward_mangled():
    """The mangled names of the forward-body instances that the forward's
    `launch<…>` calls instantiate (the impl entry points' `IMPL` standing for
    each of K9a-c, a dispatched launch for every width and type)."""
    source = kernel_ab.SOURCE.read_text()
    impl_ids = {"": 0, "FLAT": 0, "WORD_RANGE": 1, "WORD_LOOP": 2, "SUBTILE": 3}
    out = []
    for width_type, stats, bidir, impl in set(re.findall(
            r"launch<(64, float|64, __nv_bfloat16|" + re.escape(DISPATCHED)
            + r"),\s*(true|false), (true|false)(?:, (\w+))?>", source)):
        for d, t in _instances(width_type):
            for im in ["WORD_RANGE", "WORD_LOOP", "SUBTILE"] if impl == "IMPL" else [impl]:
                out.append(f"_ZN12_GLOBAL__N_118causal_flat_kernelILi{d}E{MANGLED_T[t]}"
                           f"Lb{int(stats == 'true')}ELb{int(bidir == 'true')}ELi{impl_ids[im]}"
                           "EEEvPKT0_")
    return sorted(set(out))


def _backward_mangled(launcher):
    """The mangled names (up to the first parameter, as nvcc's build log
    spells them) of the backward-body instances that `launcher` (the
    template launch_dq or launch_dkv of block_sparse_diff.cu) launches, for
    each width and element type the entry points instantiate it with."""
    source = kernel_ab.DIFF_SOURCE.read_text()
    body = source[source.index(f"cudaError_t {launcher}("):]
    body = body[:body.index("\n}\n")]
    calls = set(re.findall(rf"\b{launcher}<(64, float|64, __nv_bfloat16|"
                           + re.escape(DISPATCHED) + r")>\(", source))
    return sorted({f"_ZN53_GLOBAL__N__24bbea32_20_block_sparse_diff_cu_bf66d488{len(name)}{name}"
                   f"ILi{d}E{MANGLED_T[t]}EEvPKT0_"
                   for name in set(re.findall(r"(causal_(?:dq|dkv)_kernel)<D, T><<<", body))
                   for call in calls for d, t in _instances(call)})


@pytest.mark.parametrize("name", sorted(kernel_ab.DIFF_KNOCKOUTS))
def test_backward_knockouts_apply_to_the_source(tmp_path, monkeypatch, name):
    """Each backward knock-out's edits find their text in
    block_sparse_diff.cu exactly once, and the copy differs where they do."""
    monkeypatch.setattr(kernel_ab, "BUILD", tmp_path)
    sources = kernel_ab.knockout_sources(kernel_ab.DIFF_SOURCE, kernel_ab.DIFF_KNOCKOUTS, "ko-bwd")
    assert set(sources) == {f"ko-bwd-{n}" for n in kernel_ab.DIFF_KNOCKOUTS}
    path, include = sources[f"ko-bwd-{name}"]
    text, original = path.read_text(), kernel_ab.DIFF_SOURCE.read_text()
    assert text != original
    for old, _ in kernel_ab.DIFF_KNOCKOUTS[name]:
        assert original.count(old) == 1, old
        assert old not in text, old
    assert include == kernel_ab.DIFF_SOURCE.parent


@pytest.mark.parametrize("launcher, kids", [("launch_dq", "K3/K7"), ("launch_dkv", "K4/K8")])
def test_backward_instances_are_named(launcher, kids):
    """The spill and HMMA checks name each backward instance that the
    launcher launches by its kernels and width (at 80 the unsharded
    kernel's alone: the windows take 64); the entry points are not
    instances."""
    mangled = _backward_mangled(launcher)
    assert len(mangled) == 4
    assert {chip_smoke.instance_name(m) for m in mangled} == {
        f"{kids} float32 D64", f"{kids} bfloat16 D64", f"{kids[:2]} float32 D80",
        f"{kids[:2]} bfloat16 D80"}
    assert chip_smoke.instance_name(f"sea_causal_{launcher[7:]}") is None


@pytest.mark.parametrize("want", sorted(
    name for name in chip_smoke.required_instances() if not name.startswith(("K3", "K4"))))
def test_forward_instances_still_named(want):
    """After the PTX helpers moved to sea_mma.cuh, the forward's source still
    launches every instance it did, each named by `instance_name`."""
    assert want in {chip_smoke.instance_name(m) for m in _forward_mangled()}


def test_required_instances_are_the_launched_ones():
    """tensor_core_check requires exactly the instances both sources launch."""
    launched = {chip_smoke.instance_name(m) for m in _forward_mangled()}
    for launcher in ("launch_dq", "launch_dkv"):
        launched |= {chip_smoke.instance_name(m) for m in _backward_mangled(launcher)}
    assert launched == chip_smoke.required_instances()
