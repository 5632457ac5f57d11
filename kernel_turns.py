"""Times, on one CUDA card, the cluster and the peer kernel (lag 1 and
2) on the scale config's mesh-4 block (W=20, X=9, Y=25; B=64, jittered
costs) in each shared-memory mode, with the checkout given as the first
argument, and prints one JSON line: the block, the dynamic shared bytes
and the ms per relaxation (CUDA events over 20 calls) of each, the
nonzero spill lines of the build, and the label given as the second
argument.  Two versions are compared in one call, in turns, from the
root of a checkout that has the other one unpacked under
scratch_chip/parent:

    for c in parent change change parent; do
      d=.; [ $c = parent ] && d=scratch_chip/parent
      python3 kernel_turns.py $d $c
    done
"""
import json
import os
import sys


def main(checkout: str, label: str) -> None:
    root = os.path.abspath(checkout)
    sys.path.insert(0, root)
    os.chdir(root)

    import numpy as np

    import chip_smoke as cs
    from parallel_eda_tpu_torch.flow import synth_flow
    from parallel_eda_tpu_torch.route import planes as P
    from parallel_eda_tpu_torch.route import planes_kernels as pk
    from parallel_eda_tpu_torch.route import planes_shard as TS

    info = pk.LIB.finish_build(pk.LIB.start_build())
    f = synth_flow(**cs.SCALE_CFG)
    pg = P.build_planes(f.rr, "cuda")
    rng = np.random.default_rng(3)
    B, nsw, s = 64, 32, 4
    inst = cs._instance(f.rr, pg, B, rng, False)
    card = inst[0].device
    cap = TS.sweep_cap(nsw, s)
    W, X, Y = pg.shape_x[0], TS.row_block_cols(pg, s) + 2, pg.shape_x[2] - 1
    out = dict(checkout=label, ptxas_spills=[
        line for line in info["ptxas"]
        if "spill" in line and not line.startswith("0 bytes")][:8])
    for mode in (None, 1, 0):
        for name, kind, fn in (
                ("cluster", pk.CLUSTER,
                 lambda m: pk.planes_relax_cluster_cuda(
                     pg, *inst, cap, s, mode=m)),
                ("peer_lag1", pk.PEER,
                 lambda m: pk.planes_relax_peer_cuda(
                     pg, *inst, cap, (card,) * s, False, mode=m)),
                ("peer_lag2", pk.PEER,
                 lambda m: pk.planes_relax_peer_cuda(
                     pg, *inst, cap, (card,) * s, True, mode=m))):
            fn(mode)
            wr = (pk.planes_relax_cluster_cuda if kind == pk.CLUSTER
                  else pk.planes_relax_peer_cuda)
            got = wr.last_mode
            ms = cs.cuda_ms(lambda: fn(mode), 20)
            out[f"{name}/mode{got}"] = dict(
                block=[W, X, Y], smem=pk.smem_bytes(kind, got, W, X, Y),
                ms=ms)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
