"""Run a function on N gloo ranks of a CPU world, one process a rank; and
start a child process whose result is read later.

``run_ranks(fn, n, tmpdir, *args)`` spawns ``n`` processes; each joins a
gloo world through a ``FileStore`` in ``tmpdir``, runs PyTorch on one
thread, calls ``fn(rank, n, *args)`` and leaves the world.  ``fn`` must be
importable by name (a module-level function).  A rank that raises fails
the call.

``with Child(argv, env) as child:`` starts ``argv`` at once;
``child.wait()`` returns its standard output and fails unless it exited
0; leaving the block kills it if it still runs.  A test file starts its
reference's child first and runs its own side meanwhile.
"""

import os
import subprocess

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _entry(rank, n, store, fn, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, n), rank=rank, world_size=n)
    try:
        fn(rank, n, *args)
    finally:
        dist.destroy_process_group()


def run_ranks(fn, n, tmpdir, *args):
    store = os.path.join(str(tmpdir), f"store_{fn.__name__}_{n}")
    if os.path.exists(store):
        os.remove(store)
    mp.spawn(_entry, args=(n, store, fn, args), nprocs=n, join=True)


class Child:
    def __init__(self, argv, env, timeout=300):
        self.proc = subprocess.Popen(argv, env=env, stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True)
        self.timeout = timeout

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.communicate()

    def wait(self) -> str:
        out, err = self.proc.communicate(timeout=self.timeout)
        assert self.proc.returncode == 0, err[-4000:]
        return out
