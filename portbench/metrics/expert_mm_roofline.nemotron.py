"""The routed experts' grouped products' share of their roofline in a
Nemotron-H prefill, %: their FLOPs (``counts_hybrid_moe.expert_mm`` of
every MoE layer) at the bf16 peak over the device time of the grouped
GEMM kernels (``torch._grouped_mm``'s) in the profiled prefills."""

# ``torch._grouped_mm``'s kernels on sm_90, as ``devtrace.short_name``
# keeps them: its CUTLASS grouped GEMM (a mangled name, its first 64
# characters) and the kernel that lays out the groups' problems
NAMES = ("_ZN7cutlass13device_kernelIN2at4cuda6detail25enable_3x_kernel_fo",
         "prepare_grouped_gemm_data")


def read(rec):
    prof = rec.profile
    work = rec.counts.get("expert_mm")
    bound = rec.roofline_s(work) if work is not None else None
    if not prof.kernel_count(NAMES) or bound is None:
        return None
    return 100.0 * bound * prof.units / prof.kernel_seconds(NAMES)
