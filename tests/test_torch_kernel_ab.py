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


def test_tensor_core_check_names_every_instance():
    """The instances the entry points launch, as nvcc mangles them
    (`causal_flat_kernel<64, T, STATS, BIDIR, IMPL>` in an anonymous
    namespace), map onto the kernel ids the check requires."""
    source = kernel_ab.SOURCE.read_text()
    launched = set(re.findall(
        r"launch<64, (float|__nv_bfloat16), (true|false), (true|false)(?:, (\w+))?>", source))
    impl_ids = {"": 0, "FLAT": 0, "WORD_RANGE": 1, "WORD_LOOP": 2, "SUBTILE": 3}
    names = set()
    for dt, stats, bidir, impl in launched:
        impls = ["WORD_RANGE", "WORD_LOOP", "SUBTILE"] if impl == "IMPL" else [impl]
        for im in impls:
            mangled_t = "f" if dt == "float" else "13__nv_bfloat16"
            mangled = (f"_ZN12_GLOBAL__N_118causal_flat_kernelILi64E{mangled_t}"
                       f"Lb{int(stats == 'true')}ELb{int(bidir == 'true')}ELi{impl_ids[im]}EEEvPKT0_")
            m = chip_smoke.FLAT_INSTANCE.search(mangled)
            assert m, mangled
            d, s, b, i = m.groups()
            names.add(chip_smoke.instance_name(mangled))
    assert names == {"K1 float32", "K1 bfloat16", "K2/K6 float32", "K2 bfloat16", "K5 float32",
                     "K5 bfloat16", *(f"K9{c} {t}" for c in "abc" for t in ("float32", "bfloat16"))}


def _forward_mangled():
    """The mangled names of the forward-body instances that the forward's
    `launch<…>` calls instantiate (the impl entry points' `IMPL` standing for
    each of K9a-c)."""
    source = kernel_ab.SOURCE.read_text()
    impl_ids = {"": 0, "FLAT": 0, "WORD_RANGE": 1, "WORD_LOOP": 2, "SUBTILE": 3}
    out = []
    for dt, stats, bidir, impl in set(re.findall(
            r"launch<64, (float|__nv_bfloat16), (true|false), (true|false)(?:, (\w+))?>", source)):
        for im in ["WORD_RANGE", "WORD_LOOP", "SUBTILE"] if impl == "IMPL" else [impl]:
            mangled_t = "f" if dt == "float" else "13__nv_bfloat16"
            out.append(f"_ZN12_GLOBAL__N_118causal_flat_kernelILi64E{mangled_t}"
                       f"Lb{int(stats == 'true')}ELb{int(bidir == 'true')}ELi{impl_ids[im]}EEEvPKT0_")
    return out


def _backward_mangled(launcher):
    """The mangled names (up to the first parameter, as nvcc's build log
    spells them) of the backward-body instances that `launcher` (the
    template launch_dq or launch_dkv of block_sparse_diff.cu) launches, for
    each element type the entry points instantiate it with."""
    source = kernel_ab.DIFF_SOURCE.read_text()
    body = source[source.index(f"cudaError_t {launcher}("):]
    body = body[:body.index("\n}\n")]
    types = set(re.findall(rf"\b{launcher}<(float|__nv_bfloat16)>\(", source))
    mangled_t = {"float": "f", "__nv_bfloat16": "13__nv_bfloat16"}
    return [f"_ZN53_GLOBAL__N__24bbea32_20_block_sparse_diff_cu_bf66d488{len(name)}{name}"
            f"ILi{d}E{mangled_t[t]}EEvPKT0_"
            for name, d in set(re.findall(r"(causal_(?:dq|dkv)_kernel)<(\d+), T><<<", body))
            for t in types]


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
    launcher launches by its kernels (the bf16 one the unsharded kernel's
    alone); the entry points are not instances."""
    mangled = _backward_mangled(launcher)
    assert len(mangled) == 2
    assert {chip_smoke.instance_name(m) for m in mangled} == {
        f"{kids} float32", f"{kids[:2]} bfloat16"}
    assert chip_smoke.instance_name(f"sea_causal_{launcher[7:]}") is None


@pytest.mark.parametrize("want", sorted(
    name for kid in chip_smoke.INSTANCE_KIDS.values()
    for name in (f"{kid} float32", f"{chip_smoke.BF16_KIDS.get(kid, kid)} bfloat16")))
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
