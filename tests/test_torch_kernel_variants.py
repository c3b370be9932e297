"""The variant tool of the port's kernels (``repro_torch.kernels.variants``)
rewrites the committed CUDA sources by text substitution; every anchor it
replaces must occur in its source exactly once, or a variant would time
something else than it names."""
import pytest

from repro_torch.kernels import _build, variants


@pytest.mark.parametrize("name", sorted(variants.VARIANTS))
def test_variant_anchors_occur_once(name):
    lib, subs, _ = variants.VARIANTS[name]
    text = (_build.CSRC / f"{lib}.cu").read_text()
    for old, new in subs:
        assert text.count(old) == 1, (name, old)
        assert new != old
        text = text.replace(old, new)


def test_variants_need_a_card(monkeypatch):
    monkeypatch.setattr(variants.torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="needs a CUDA card"):
        variants.main([])


def test_ptxas_summary_names_kernels_with_their_template_argument():
    """``_build.ptxas_summary`` turns an ``-Xptxas -v`` report (spills
    before registers, mangled names) into one line a kernel."""
    log = "\n".join([
        "ptxas info    : Compiling entry function "
        "'_ZN2wg13flash_wgmma_kILi64EEEv14CUtensorMap_stS1_S1_P13__nv_"
        "bfloat16iiixxxfiif' for 'sm_90a'",
        "    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads",
        "ptxas info    : Used 168 registers, used 1 barriers",
        "ptxas info    : Compiling entry function '_ZN44_GLOBAL__N__184f87bf"
        "_11_ssd_scan_cu_32a6222e8output_kI13__nv_bfloat16EEvPKT_' for "
        "'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 64 registers, used 1 barriers",
        "ptxas info    : Compiling entry function '_ZN44_GLOBAL__N__184f87bf"
        "_11_ssd_scan_cu_32a6222e6pass_kEPfPKfS0_iNS_4DimsE' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 32 registers, used 0 barriers"])
    assert _build.ptxas_summary(log) == [
        "flash_wgmma_k<64>: 168 registers, 4 bytes spill stores",
        "output_k<bf16>: 64 registers, 0 bytes spill stores",
        "pass_k: 32 registers, 0 bytes spill stores"]
    assert variants.registers(log) == (
        "flash_wgmma_k<64>: 168 registers, 4 bytes spill stores; "
        "output_k<bf16>: 64 registers, 0 bytes spill stores")
