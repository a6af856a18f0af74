"""The chip tools' source-reading parts, on the CPU: kernel_ab.py's
knock-outs must each find their text in the CUDA source exactly once (or the
tool would time an unchanged copy), and chip_smoke.py's tensor-core check
must name every `causal_flat_kernel` instance from its mangled name."""

import re

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
            names.add(f"{chip_smoke.INSTANCE_KIDS[int(s), int(b), int(i)]} "
                      f"{'float32' if d == 'f' else 'bfloat16'}")
    assert names == {"K1 float32", "K1 bfloat16", "K2/K6 float32", "K5 float32", "K5 bfloat16",
                     *(f"K9{c} {t}" for c in "abc" for t in ("float32", "bfloat16"))}
