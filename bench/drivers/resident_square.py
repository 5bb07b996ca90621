"""C = A A, with A resident on the configuration's workers, through ``repro_torch.dist``.

Traffic keys: ``operation``, a function of ``repro_torch.dist`` called as
``op(a, a, cache, **kwargs)``; ``kwargs``; ``kernels``, the port's CUDA
sources the call launches, built or loaded in set-up; ``warm_calls``, the
calls set-up makes (the first builds and verifies the plan).  Configuration
keys besides the family's: ``workers``, ``dtype`` and ``control``, the
precision the control computes in (``bench.reference.blocksparse.product``).

The inputs are drawn from the seed on the device; the program receives only
them.  The judge draws them again, works the product's structure out from
A's coordinates and multiplies in float64: the plan's structure, the
exchange's blocks, the kernel's values and the assembly into global block
order are all judged.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from bench.reference.blocksparse import product, product_tasks
from bench.reference.compare import compare
from bench.structure import Structure, draw_values
from bench.workload import Answer, checksum, dtype_of, sync


def answer(c) -> Answer:
    """The result ``c``, a ``DistBSMatrix``, read from the program's own store
    through its owner and slot maps."""
    owner = torch.from_numpy(np.asarray(c.owner, np.int64)).to(c.store.device)
    slot = torch.from_numpy(np.asarray(c.slot, np.int64)).to(c.store.device)

    def blocks(idx: np.ndarray) -> torch.Tensor:
        i = torch.from_numpy(np.asarray(idx, np.int64)).to(c.store.device)
        return c.store[owner[i], slot[i]]

    return Answer(np.asarray(c.coords), blocks)


class Driver:
    def __init__(self, config: dict, traffic: dict, structure: Structure, seed: int, device,
                 cache=None):
        self.config, self.traffic, self.structure, self.seed = config, traffic, structure, int(seed)
        self.cache = cache  # the plan cache to start from; a run starts from an empty one
        self.device = torch.device(device)
        self.dtype = dtype_of(config)
        self.kwargs = dict(traffic.get("kwargs", {}))

    def setup(self) -> dict:
        split = {}
        t = time.perf_counter()
        import repro_torch.dist as dist
        from repro_torch.core import BSMatrix
        from repro_torch.core.distributed import make_worker_mesh

        split["program_import_s"] = time.perf_counter() - t
        if self.device.type == "cuda":
            t = time.perf_counter()
            torch.cuda.init()
            torch.empty(1, device=self.device)
            sync(self.device)
            split["cuda_start_s"] = time.perf_counter() - t
            t = time.perf_counter()
            from repro_torch.kernels import build

            names = list(self.traffic.get("kernels", []))
            build.build_all(names)
            for name in names:
                build.load_library(name)
            split["kernel_build_s"] = time.perf_counter() - t
        t = time.perf_counter()
        s = self.structure
        values = draw_values(s, self.seed, self.device, self.dtype)
        self.input_checksum = checksum(values)
        sync(self.device)
        split["draw_s"] = time.perf_counter() - t
        t = time.perf_counter()
        mesh = make_worker_mesh(self.config["workers"], self.device)
        a = dist.scatter(BSMatrix(shape=(s.n, s.n), bs=s.bs, coords=s.coords, data=values), mesh)
        del values  # the program keeps its own store; the judge draws the inputs again
        sync(self.device)
        split["scatter_s"] = time.perf_counter() - t
        self._op, self._a = getattr(dist, self.traffic["operation"]), a
        if self.cache is None:
            self.cache = dist.PlanCache()
        for k in range(int(self.traffic["warm_calls"])):
            t = time.perf_counter()
            self.call()
            sync(self.device)
            split[f"warm_call_{k}_s"] = time.perf_counter() - t
        return split

    def call(self):
        return self._op(self._a, self._a, self.cache, **self.kwargs)

    answer = staticmethod(answer)

    def counters(self) -> dict:
        c = self.cache
        return dict(hits=c.hits, misses=c.misses, build_s=c.build_s, verify_s=c.verify_s)

    def release(self) -> None:
        self._a = self._op = self.cache = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def judge(self, answers: dict, control: bool = False):
        values = draw_values(self.structure, self.seed, self.device, self.dtype)
        if checksum(values) != self.input_checksum:
            raise RuntimeError("a second draw of the inputs differs from the first")
        s = self.structure
        tasks = product_tasks(s.coords, s.coords)
        want = product(values, values, tasks, precision="float64")
        results = {name: compare(tasks.c_coords, want, a.coords, a.blocks, held=a.held)
                   for name, a in answers.items()}
        if control:
            low = product(values, values, tasks, precision=self.config["control"])
            del values
            results["control"] = compare(tasks.c_coords, want, tasks.c_coords, lambda idx: low[idx])
        work = dict(tasks=tasks.num_tasks, bs=s.bs, a_blocks=s.nnzb, c_blocks=tasks.num_out,
                    dtype=self.config["dtype"])
        return work, results
