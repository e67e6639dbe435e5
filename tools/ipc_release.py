"""Does a tensor that gloo peers on one card mapped through CUDA IPC get
freed on its owner once every side drops it?  Four ranks of one NVIDIA
GPU (`launch.mesh.spawn`, gloo), each exporting a 256 MB tensor to the
others under five drop orders: one `reduce_tensor` for every peer or one
per peer, the peers' mappings dropped before or after the owner's
tensor, with and without `gc.collect()`, each followed by a barrier and
`torch.cuda.ipc_collect()`.  Prints each rank's allocated MB before the
export, while mapped, after the drop and after a second collect.

    python3 tools/ipc_release.py

This is why no serving store is mapped by its peers
(`repro_torch.launch.placement`): on PyTorch 2.11 and four ranks of an
H100, every order where the peers dropped first kept the owner's 256 MB
allocated on every rank; one reduce with the owner first freed it on
two ranks and kept it on the other two; a reduce per peer with the
owner first kept it on every rank.
"""
import gc
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

#: (name, a reduce per peer, the owner drops first, gc.collect())
ORDERS = (("one reduce, peers first", False, False, False),
          ("one reduce, owner first", False, True, False),
          ("one reduce, peers first, gc", False, False, True),
          ("a reduce per peer, peers first", True, False, False),
          ("a reduce per peer, owner first", True, True, False))


def rank(dev):
    import torch
    import torch.distributed as dist
    from torch.multiprocessing.reductions import reduce_tensor
    from repro_torch.launch.mesh import make_test_mesh
    mesh = make_test_mesh(2, 2, device=dev)
    out = {}

    def mb():
        torch.cuda.synchronize()
        return round(torch.cuda.memory_allocated() / 1e6, 1)

    for name, per_peer, owner_first, collect in ORDERS:
        base = mb()
        x = torch.ones(64 << 20, dtype=torch.int32, device=dev)
        torch.cuda.synchronize()
        h = [None] * mesh.size
        if per_peer:
            dist.all_gather_object(h, [reduce_tensor(x)
                                       for _ in range(mesh.size)])
            peers = {r: h[r][mesh.rank][0](*h[r][mesh.rank][1])
                     for r in range(mesh.size) if r != mesh.rank}
        else:
            dist.all_gather_object(h, reduce_tensor(x))
            peers = {r: fn(*a) for r, (fn, a) in enumerate(h)
                     if r != mesh.rank}
        for p in peers.values():        # the mappings are read
            p[:4].sum().item()
        mapped = mb()
        del h
        if owner_first:
            del x
        del peers
        if collect:
            gc.collect()
        torch.cuda.synchronize()
        mesh.barrier()
        if not owner_first:
            del x
        torch.cuda.ipc_collect()
        released = mb()
        mesh.barrier()
        torch.cuda.ipc_collect()
        out[name] = (base, mapped, released, mb())
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("ipc_release: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.launch.mesh import spawn
    print(torch.cuda.get_device_name(0), flush=True)
    for k, r in enumerate(spawn(rank, 4, device="cuda")):
        for name, v in r.items():
            print(f"rank {k} {name}: MB allocated before {v[0]}, mapped "
                  f"{v[1]}, after the drop {v[2]}, after a second collect "
                  f"{v[3]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
