"""Build every kernel source, check the generated-collective kernels by
part on the GPU, and time 8 x 16 Mi f32 launches whole and by part.

Usage, on a machine with an NVIDIA GPU and nvcc (from the repo root):

    python3 tools/gen_parts_probe.py

Prints the build's seconds, the ptxas/SASS facts of gen_device.cu,
gen_fold.cu and gen_fold_part.cu (their f32/bf16 instances must hold
128-bit global loads and stores, no instance may spill), runs
chip_smoke.py's generated-kernel checks and its checks by part, then,
for gen_ring_c2, gen_rhd_r2 and gen_bc_kn_r2 (in place) over 8 ranks of
16 Mi f32, the single launch four times and each part of P = 2 and 4
alone (CUDA events, 10 launches each), with the card's name and power
limit beside them.
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    sys.modules.setdefault("jax", None)      # the port must not need JAX
    import torch
    if not torch.cuda.is_available():
        print("gen_parts_probe: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from ucc_tpu_torch import ReductionOp
    from ucc_tpu_torch.dsl import registry as reg
    from ucc_tpu_torch.kernels import build, cuda_ipc, ec_reduce as ker
    from ucc_tpu_torch.kernels import gen_device as kgd
    from ucc_tpu_torch.kernels import ring_allreduce as kr
    from ucc_tpu_torch.kernels import ring_attention as ka
    from ucc_tpu_torch.kernels import ring_bcast_a2a as kba
    from ucc_tpu_torch.kernels import ring_common as kc
    from ucc_tpu_torch.kernels import ring_rs_ag as krs

    smi = cs.smi_line()
    print(smi, flush=True)
    t0 = time.perf_counter()
    gen = [kgd.SOURCE, kgd.FOLD_SOURCE, kgd.FOLD_PART_SOURCE]
    sources = [kr.SOURCE, krs.RS_SOURCE, krs.SOURCE, kba.SOURCE,
               kba.A2A_SOURCE, ker.SOURCE, ka.SOURCE, cuda_ipc.SOURCE] + gen
    reports = {}
    print("build of all sources", build.build_all(sources, reports=reports),
          flush=True)
    infos = {s: cs.ptxas_read(s, reports.get(s)) for s in gen}
    print("ptxas and SASS", time.perf_counter() - t0, flush=True)
    cs.check_direct_sass(kgd.FOLD_SOURCE, infos[kgd.FOLD_SOURCE])
    cs.check_direct_sass(kgd.FOLD_PART_SOURCE, infos[kgd.FOLD_PART_SOURCE])
    cs.check_spills(infos)
    cs.phase_kernels_gen_device()
    cs.phase_kernels_gen_parts()
    n, count = cs.N_RANKS, cs.MAIN_COUNT
    for fam, param, root in (("ring", 2, 0), ("rhd", 2, 0), ("bc_kn", 2, 3)):
        prog = reg.build_program(fam, param, n)
        plan, wrapper, route = cs.gen_route(prog, n, count, root)
        ins = cs.make_inputs(n, count, torch.float32, ReductionOp.SUM, 5)
        op = ReductionOp.SUM if plan.reducing else None
        dsts = [torch.empty_like(s) for s in ins] if plan.reducing else ins
        table = kc.make_ptr_table(ins, dsts)
        line = []
        for nparts in (2, 4):
            parts = [cs.cuda_ms(lambda p=p: wrapper(
                ins, dsts, op, plan=plan, ptr_table=table,
                part=(p, nparts)), 10) for p in range(nparts)]
            line.append(f"P={nparts}: "
                        f"{' + '.join(f'{m:.4f}' for m in parts)} = "
                        f"{sum(parts):.4f}")
        whole = [cs.cuda_ms(lambda: wrapper(ins, dsts, op, plan=plan,
                                            ptr_table=table), 10)
                 for _ in range(4)]
        print(f"{prog.name} {n} x {count} ({route}): whole "
              f"{', '.join(f'{m:.4f}' for m in whole)} ms | "
              f"{' | '.join(line)} | {smi}", flush=True)
        del ins, dsts, table
        torch.cuda.empty_cache()
    print("done", time.perf_counter() - t0, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
