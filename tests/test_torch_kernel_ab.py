"""The chip tools' source-reading parts, on the CPU: kernel_ab.py's
knock-outs must each find their text in the CUDA source exactly once, within
the body they knock out (or the tool would time an unchanged copy), and
chip_smoke.py's tensor-core check must name every instance of the forward
bodies (`causal_wgmma_kernel`, the bf16 instances on wgmma,
`causal_tf32_wgmma_kernel`, the float32 ones on wgmma in split TF32, and
`causal_flat_kernel`, K5's float32 instance on mma.sync) and of the backward
bodies (`causal_dq_wgmma_kernel` and `causal_dkv_wgmma_kernel`, the bf16
instances on wgmma, `causal_dq_f32_wgmma_kernel` and
`causal_dkv_f32_wgmma_kernel`, the float32 ones on wgmma in three bf16
terms) from its mangled name."""

import re

import pytest

import chip_smoke
import kernel_ab


def _scoped(text, scope):
    """The part of a source that a body's knock-outs edit (kernel_ab's
    scope markers)."""
    lo = text.index(scope[0])
    return text[lo:text.index(scope[1], lo) if scope[1] else len(text)]


def test_knockouts_apply_to_the_source(tmp_path, monkeypatch):
    """The bf16 forward body's knock-outs edit `causal_wgmma_kernel` alone
    (the float32 body repeats some of their lines)."""
    monkeypatch.setattr(kernel_ab, "BUILD", tmp_path)
    sources = kernel_ab.knockout_sources()
    original = kernel_ab.SOURCE.read_text()
    assert set(sources) == {f"ko-{n}" for n in kernel_ab.KNOCKOUTS}
    assert "causal_tf32_wgmma_kernel" not in _scoped(original, kernel_ab.BF16_SCOPE)
    for name, (path, include) in sources.items():
        text = path.read_text()
        assert text != original, name
        assert _scoped(text, kernel_ab.F32_SCOPE) == _scoped(original, kernel_ab.F32_SCOPE)
        for old, _ in kernel_ab.KNOCKOUTS[name[3:]]:
            assert old not in _scoped(text, kernel_ab.BF16_SCOPE), (name, old)
        assert include == kernel_ab.SOURCE.parent


@pytest.mark.parametrize("name", sorted(kernel_ab.F32_KNOCKOUTS))
def test_f32_knockouts_apply_to_the_new_body(tmp_path, monkeypatch, name):
    """Each knock-out of the float32 body finds its text once in the source
    from `causal_tf32_wgmma_kernel`'s section on and leaves the bf16 body as
    it is."""
    monkeypatch.setattr(kernel_ab, "BUILD", tmp_path)
    sources = kernel_ab.knockout_sources(kernel_ab.SOURCE, kernel_ab.F32_KNOCKOUTS, "ko-f32")
    assert set(sources) == {f"ko-f32-{n}" for n in kernel_ab.F32_KNOCKOUTS}
    path, include = sources[f"ko-f32-{name}"]
    text, original = path.read_text(), kernel_ab.SOURCE.read_text()
    body, knocked = _scoped(original, kernel_ab.F32_SCOPE), _scoped(text, kernel_ab.F32_SCOPE)
    assert "causal_tf32_wgmma_kernel(" in body and knocked != body
    assert _scoped(text, kernel_ab.BF16_SCOPE) == _scoped(original, kernel_ab.BF16_SCOPE)
    for old, new in kernel_ab.F32_KNOCKOUTS[name]:
        assert body.count(old) == 1, old
        assert old not in knocked or old in new, old
    assert include == kernel_ab.SOURCE.parent


def _width_lists():
    """{name: [widths]} of the head-width lists in csrc/sea_mask.cuh
    (`using NAME = Widths<...>`), each entry point's instances."""
    header = (kernel_ab.SOURCE.parent / "sea_mask.cuh").read_text()
    return {name: [w.strip() for w in widths.split(",")]
            for name, widths in re.findall(r"using (\w+) = Widths<([\d, ]+)>;", header)}


# a launch's template arguments as the sources spell them: an explicit width
# and type, or the dispatched ones (every width of the list the entry point
# dispatches over, both types)
DISPATCHED = "decltype(d)::value, typename decltype(t)::type"
MANGLED_T = {"float": "f", "__nv_bfloat16": "13__nv_bfloat16"}


def _dispatched(source: str) -> str:
    """`source` with each dispatched launch's template arguments replaced by
    `widths NAME`, NAME the list its `sea::dispatch(sea::NAME{}, ...)`
    dispatches over."""
    return re.sub(r"sea::dispatch\(sea::(\w+)\{\}(.*?)" + re.escape(DISPATCHED),
                  lambda m: f"sea::dispatch(sea::{m.group(1)}{{}}{m.group(2)}widths {m.group(1)}",
                  source, flags=re.S)


def _instances(width_type: str):
    """[(width, type)] of one launch's first template arguments."""
    if width_type.startswith("widths "):
        return [(d, t) for d in _width_lists()[width_type[7:]] for t in MANGLED_T]
    d, t = width_type.split(", ")
    return [(d, t)]


def test_tensor_core_check_names_every_instance():
    """The instances the entry points launch, as nvcc mangles them
    (`causal_tf32_wgmma_kernel<D, STATS, BIDIR, IMPL>` for float32 but K5's,
    `causal_flat_kernel<…>`, and `causal_wgmma_kernel<D, STATS, BIDIR, IMPL>`
    for bf16, in an anonymous namespace), map onto the kernel ids and widths
    the check requires."""
    names = set()
    for mangled in _forward_mangled():
        assert chip_smoke.FLAT_INSTANCE.search(mangled), mangled
        names.add(chip_smoke.instance_name(mangled))
    assert _width_lists() == {"FORWARD_WIDTHS": ["32", "64", "80", "128"],
                              "TRAIN_WIDTHS": ["64", "80", "128"],
                              "BIDIR_WIDTHS": ["32", "64"], "BASE_WIDTHS": ["64"]}
    assert names == {f"{kid} {t} D{d}" for t in ("float32", "bfloat16") for kid, d in (
        ("K1", 64), ("K2/K6", 64), ("K5", 64), ("K9a", 64), ("K9b", 64), ("K9c", 64),
        ("K1", 80), ("K2", 80), ("K1", 128), ("K2", 128), ("K1", 32), ("K5", 32))}


# the forward body each element type's `launch<…>` instantiates, and how its
# mangled name goes on after the template arguments (its first parameters:
# the TMA tensor maps of both wgmma bodies), and K5's float32 body on
# mma.sync (float32 pointers)
K5_FLOAT_BODY = ("causal_flat_kernel", "EEEvPKfS1_")
FORWARD_BODIES = {"float": ("causal_tf32_wgmma_kernel", "EEEv14CUtensorMap_stS0_S0_"),
                  "__nv_bfloat16": ("causal_wgmma_kernel", "EEEv14CUtensorMap_stS0_S0_")}


def _forward_mangled():
    """The mangled names of the forward-body instances that the forward's
    `launch<…>` calls instantiate (the impl entry points' `IMPL` standing for
    each of K9a-c, a dispatched launch for every width and type)."""
    source = _dispatched(kernel_ab.SOURCE.read_text())
    impl_ids = {"": 0, "FLAT": 0, "WORD_RANGE": 1, "WORD_LOOP": 2, "SUBTILE": 3}
    out = []
    for width_type, stats, bidir, impl in set(re.findall(
            r"launch<(64, float|64, __nv_bfloat16|widths \w+),\s*(true|false), (true|false)"
            r"(?:, (\w+))?>", source)):
        for d, t in _instances(width_type):
            for im in ["WORD_RANGE", "WORD_LOOP", "SUBTILE"] if impl == "IMPL" else [impl]:
                body, rest = (K5_FLOAT_BODY if (t, bidir) == ("float", "true")
                              else FORWARD_BODIES[t])
                out.append(f"_ZN12_GLOBAL__N_1{len(body)}{body}ILi{d}E"
                           f"Lb{int(stats == 'true')}ELb{int(bidir == 'true')}ELi{impl_ids[im]}"
                           + rest)
    return sorted(set(out))


# the backward body each element type's `launch_dq<…>`/`launch_dkv<…>`
# launches, and how its mangled name goes on after the template argument
# (its first parameters: the TMA tensor maps of both bodies)
BACKWARD_BODIES = {"float": ("causal_{}_f32_wgmma_kernel", "EEv14CUtensorMap_stS0_S0_S0_"),
                   "__nv_bfloat16": ("causal_{}_wgmma_kernel", "EEv14CUtensorMap_stS0_S0_S0_")}


def _backward_mangled(launcher):
    """The mangled names of the backward-body instances that `launcher`
    (the template launch_dq or launch_dkv of block_sparse_diff.cu) launches,
    for each width and element type the entry points instantiate it with:
    its float32 body in three bf16 terms (`causal_dq_f32_wgmma_kernel<D>`,
    `causal_dkv_f32_wgmma_kernel<D>`) or its bf16 body
    (`causal_dq_wgmma_kernel<D>`, `causal_dkv_wgmma_kernel<D>`), both on
    wgmma."""
    source = _dispatched(kernel_ab.DIFF_SOURCE.read_text())
    body = source[source.index(f"cudaError_t {launcher}("):]
    body = body[:body.index("\n}\n")]
    calls = set(re.findall(rf"\b{launcher}<(64, float|64, __nv_bfloat16|widths \w+)>\(",
                           source))
    out = set()
    for call in calls:
        for d, t in _instances(call):
            pattern, rest = BACKWARD_BODIES[t]
            name = pattern.format(launcher[7:])
            assert f"{name}<D><<<" in body, (launcher, name)
            out.add(f"_ZN53_GLOBAL__N__24bbea32_20_block_sparse_diff_cu_bf66d488{len(name)}{name}"
                    f"ILi{d}{rest}")
    return sorted(out)


@pytest.mark.parametrize("name", sorted(kernel_ab.DIFF_KNOCKOUTS))
def test_backward_knockouts_apply_to_the_source(tmp_path, monkeypatch, name):
    """Each knock-out of the bf16 backward bodies finds its text exactly
    once in their part of block_sparse_diff.cu (the float32 bodies repeat
    some of its lines), the copy differs where it does, and the float32
    bodies' part is left as it is."""
    monkeypatch.setattr(kernel_ab, "BUILD", tmp_path)
    sources = kernel_ab.knockout_sources(kernel_ab.DIFF_SOURCE, kernel_ab.DIFF_KNOCKOUTS, "ko-bwd")
    assert set(sources) == {f"ko-bwd-{n}" for n in kernel_ab.DIFF_KNOCKOUTS}
    path, include = sources[f"ko-bwd-{name}"]
    text, original = path.read_text(), kernel_ab.DIFF_SOURCE.read_text()
    body = _scoped(original, kernel_ab.BWD_BF16_SCOPE)
    assert "causal_dq_wgmma_kernel(" in body and "causal_dq_f32_wgmma_kernel(" not in body
    assert text != original
    assert _scoped(text, kernel_ab.BWD_F32_SCOPE) == _scoped(original, kernel_ab.BWD_F32_SCOPE)
    for old, _ in kernel_ab.DIFF_KNOCKOUTS[name]:
        assert body.count(old) == 1, old
        assert old not in _scoped(text, kernel_ab.BWD_BF16_SCOPE), old
    assert include == kernel_ab.DIFF_SOURCE.parent


@pytest.mark.parametrize("name", sorted(kernel_ab.F32_DIFF_KNOCKOUTS))
def test_f32_backward_knockouts_apply_to_the_new_bodies(tmp_path, monkeypatch, name):
    """Each knock-out of the float32 backward bodies in three bf16 terms
    finds its text once in their part of block_sparse_diff.cu (the bodies
    and the product and split helpers they share), changes it there, and
    leaves the bf16 bodies as they are."""
    monkeypatch.setattr(kernel_ab, "BUILD", tmp_path)
    sources = kernel_ab.knockout_sources(kernel_ab.DIFF_SOURCE, kernel_ab.F32_DIFF_KNOCKOUTS,
                                         "ko-bwd32")
    assert set(sources) == {f"ko-bwd32-{n}" for n in kernel_ab.F32_DIFF_KNOCKOUTS}
    path, include = sources[f"ko-bwd32-{name}"]
    text, original = path.read_text(), kernel_ab.DIFF_SOURCE.read_text()
    body, knocked = (_scoped(x, kernel_ab.BWD_F32_SCOPE) for x in (original, text))
    assert "causal_dq_f32_wgmma_kernel(" in body and "causal_dkv_f32_wgmma_kernel(" in body
    assert knocked != body
    assert _scoped(text, kernel_ab.BWD_BF16_SCOPE) == _scoped(original, kernel_ab.BWD_BF16_SCOPE)
    for old, new in kernel_ab.F32_DIFF_KNOCKOUTS[name]:
        assert body.count(old) == 1, old
        assert knocked.count(old) == (1 if old in new else 0), old
    assert include == kernel_ab.DIFF_SOURCE.parent


@pytest.mark.parametrize("launcher, kids", [("launch_dq", "K3/K7"), ("launch_dkv", "K4/K8")])
def test_backward_instances_are_named(launcher, kids):
    """The spill and tensor-core checks name each backward instance that the
    launcher launches by its kernels, type and width (at 80 and 128 the
    unsharded kernel's alone: the windows take 64); the entry points are not
    instances."""
    mangled = _backward_mangled(launcher)
    assert len(mangled) == 6
    assert {chip_smoke.instance_name(m) for m in mangled} == {
        f"{kids} float32 D64", f"{kids} bfloat16 D64", f"{kids[:2]} float32 D80",
        f"{kids[:2]} bfloat16 D80", f"{kids[:2]} float32 D128", f"{kids[:2]} bfloat16 D128"}
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


@pytest.mark.parametrize("launcher", ["launch_dq", "launch_dkv"])
def test_backward_tensor_core_ops(launcher):
    """The tensor-core check wants wgmma's HGMMA in every backward
    instance: the bf16 ones and the float32 ones in three bf16 terms; a
    float32 instance on mma.sync (`causal_dq_kernel<D>`), none of which is
    left, would be named as float32 and want HMMA."""
    for mangled in _backward_mangled(launcher):
        assert chip_smoke.tensor_core_op(mangled) == "HGMMA", mangled
    old = mangled.replace("_f32_wgmma_kernel", "_kernel").replace("_wgmma_kernel", "_kernel")
    assert chip_smoke.instance_name(old).split()[1] == "float32"
    assert chip_smoke.tensor_core_op(old) == "HMMA"


def test_forward_tensor_core_ops():
    """The forward bodies' instances run on wgmma, the float32 ones in split
    TF32, but K5's float32 instances (widths 64 and 32), which kept the
    mma.sync body: the check wants HGMMA in each of them and HMMA in those."""
    for mangled in _forward_mangled():
        want = ("HMMA" if chip_smoke.instance_name(mangled) in ("K5 float32 D64",
                                                                "K5 float32 D32")
                else "HGMMA")
        assert chip_smoke.tensor_core_op(mangled) == want, mangled
