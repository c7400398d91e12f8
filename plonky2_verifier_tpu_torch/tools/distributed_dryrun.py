"""Multi-process dry run of the sharded verifier, the counterpart of
tools/distributed_dryrun.py.

Run from the repository root:
  python3 -m plonky2_verifier_tpu_torch.tools.distributed_dryrun [--nproc N]
      [--device cpu] [--share-card] [--queries N] [--port N] [--out FILE]

Parent mode: starts `--nproc` child processes (default 2) of this host,
each with P2V_DISTRIBUTED=1 and PyTorch's MASTER_ADDR, MASTER_PORT,
WORLD_SIZE and RANK, laid out as a ('dp', 'qp') mesh with qp = 2 where
nproc is even. Every child holds the whole host batch (2 dp lanes, one of
them corrupted) and verifies its own share; the summed `n_valid` must equal
batch - 1 in EVERY process: the verdict reduction crossed the process
boundary and the fault was seen across it. Prints one JSON report; exit code
0 iff every process agrees. The report goes to `--out` too, if given.

Where the ranks run: `--device cpu` joins them with gloo on the CPU. On the
card, rank r takes CUDA card r and the group is NCCL's, and a rank without a
card of its own fails; `--share-card` puts every rank on card 0 with gloo
(NCCL refuses two ranks a device).

Child mode (`--child`): goes through `parallel.stream.init_distributed`, the
env-gated hook that the command line's `stream` uses.
"""

import argparse
import copy
import json
import os
import socket
import subprocess
import sys
import time

CHILD_TIMEOUT_S = 600


def _mesh_shape(nproc: int):
    qp = 2 if nproc % 2 == 0 else 1
    return nproc // qp, qp


def _args(argv):
    p = argparse.ArgumentParser(prog="python3 -m plonky2_verifier_tpu_torch.tools.distributed_dryrun")
    p.add_argument("--nproc", type=int, default=2)
    p.add_argument("--queries", type=int, default=8)
    p.add_argument("--device", default=None, help="without it the CUDA cards, and an error where there are too few")
    p.add_argument("--share-card", action="store_true", help="every rank on CUDA card 0, joined by gloo")
    p.add_argument("--port", type=int, default=0, help="the rendezvous port on localhost (0: a free one)")
    p.add_argument("--out", default=None, help="also write the report to this file")
    p.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    return p.parse_args(argv)


def _backend_and_device(args):
    """The process group's backend and this rank's device, from the
    arguments alone."""
    if args.device is not None and args.device.startswith("cpu"):
        return "gloo", "cpu"
    if args.share_card:
        return "gloo", "cuda:0"
    return "nccl", None  # init_distributed gives rank r card r


def child(args) -> int:
    import torch

    from ..compiler import CircuitTemplate, flatten_proofs
    from ..models.cache import get_fixture_proof
    from ..ops.field import resolve_device
    from ..parallel import init_distributed, verify_sharded

    backend, device = _backend_and_device(args)
    if device == "cpu":
        torch.set_num_threads(1)
    if not init_distributed(backend=backend, device=device):
        raise RuntimeError("the child needs P2V_DISTRIBUTED=1 in its environment")
    dp, qp = _mesh_shape(int(os.environ["WORLD_SIZE"]))
    batch, bad_lane = 2 * dp, 1

    common, vkey, pwp = get_fixture_proof("fibonacci", num_query_rounds=args.queries)
    bad = copy.deepcopy(pwp)
    bad.proof.opening_proof.pow_witness ^= 1
    arrays = flatten_proofs(CircuitTemplate(common), [(vkey, bad if i == bad_lane else pwp) for i in range(batch)])

    t0 = time.time()
    res = verify_sharded(common, arrays, dp, qp, device=device)
    want = batch - 1  # the corrupted lane must be rejected mesh-wide
    ok = res["n_valid"] == want and res["gathered"] == [i != bad_lane for i in range(batch)]
    on = resolve_device(device)
    print(
        json.dumps(
            {
                "process": res["rank"],
                "mesh": {"dp": dp, "qp": qp, "at": list(divmod(res["rank"], qp))},
                "backend": torch.distributed.get_backend(),
                "device": f"{torch.cuda.get_device_name(on)} ({on})" if on.type == "cuda" else str(on),
                "batch": batch,
                "corrupt_lane": bad_lane,
                "n_valid": res["n_valid"],
                "rejected_lanes": [i for i, lane_ok in enumerate(res["gathered"]) if not lane_ok],
                "wall_s": round(time.time() - t0, 3),
                "ok": ok,
            }
        ),
        flush=True,
    )
    torch.distributed.destroy_process_group()
    return 0 if ok else 1


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def parent(args, argv) -> int:
    import torch

    from ..models.cache import get_fixture_proof

    if _backend_and_device(args)[0] == "nccl" and torch.cuda.device_count() < args.nproc:
        raise RuntimeError(f"{args.nproc} ranks need a CUDA card each and this host has {torch.cuda.device_count()}; "
                           "--share-card puts them all on card 0, --device cpu on the CPU")
    get_fixture_proof("fibonacci", num_query_rounds=args.queries)  # cached here, so that no child is the one that proves
    port = args.port or _free_port()
    procs = []
    for rank in range(args.nproc):
        env = dict(os.environ, P2V_DISTRIBUTED="1", MASTER_ADDR="localhost", MASTER_PORT=str(port), WORLD_SIZE=str(args.nproc),
                   RANK=str(rank), LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(args.nproc))
        cmd = [sys.executable, "-m", "plonky2_verifier_tpu_torch.tools.distributed_dryrun", "--child", *argv]
        procs.append(subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    results, ok = [], True
    deadline = time.time() + CHILD_TIMEOUT_S
    try:
        for p in procs:
            try:
                out, err = p.communicate(timeout=max(1.0, deadline - time.time()))
            except subprocess.TimeoutExpired:
                p.kill()
                out, err = p.communicate()
                err += f"\nkilled after {CHILD_TIMEOUT_S} s"
            lines = [line for line in out.splitlines() if line.startswith("{")]
            if lines and p.returncode == 0:
                results.append(json.loads(lines[-1]))
            else:
                results.append({"exit_code": p.returncode, "error": err[-2000:]})
                ok = False
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    dp, qp = _mesh_shape(args.nproc)
    report = {
        "ok": ok and all(r.get("ok") for r in results),
        "processes": results,
        "mesh": {"dp": dp, "qp": qp},
        "corrupt_lane": 1,
        "transport": f"{_backend_and_device(args)[0]} across {args.nproc} processes of one host",
    }
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps(report))
    return 0 if report["ok"] else 1


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = _args(argv)
    return child(args) if args.child else parent(args, [a for a in argv if a != "--child"])


if __name__ == "__main__":
    sys.exit(main())
