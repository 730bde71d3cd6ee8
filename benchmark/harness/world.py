"""A cell's world of ranks, one card a rank.

A configuration that gives the program's mesh (``"mesh": {"px": p,
"spp": s}``, ``spec.world_shape``) runs its cells as p·s processes, rank
r on card r, joined through the program's own ``init_distributed`` and
``make_mesh`` (``port.join_world``): over NCCL where every rank has a
card of its own, over gloo on the CPU and where ranks share a card. A
configuration without one is a world of one: ``start`` returns a
``Solo``, which starts no process, forms no process group, and builds
and drives the session in this process as before.

Rank 0 is the harness process: it runs the window, the held timing, the
traced window, the program's pass and the check, and prints the result.
Ranks 1..n-1, the followers, are spawned once a run, after rank 0 has
built or loaded the kernel library (a follower builds nothing), and live
until the run ends. A follower makes its inputs from the run's seed,
builds every session rank 0 builds (``World.session``), and does what
rank 0's host tells it over a pipe of its own; rank 0 never waits for a
follower inside a call:

- in the window, one command a chunk (``Mirror.plan``): its first call
  and rank 0's elapsed seconds, which the follower hands its session's
  ``plan`` as its own, then the chunk's calls, each between the hooks
  ``before`` and ``after`` (the snapshots, the saves), with an event
  after each call and the mix's ``chunks_in_flight`` bound of its own;
  the window's ``drain`` joins: every follower drains its session,
  synchronises its card and answers with its peak memory and its device
  ms a call, so the window ends at the slowest rank's last call;
- after the window, one command a call (the held timing, the program's
  pass);
- the traced window: every rank profiles its own calls into
  ``trace_<cell>.rank<r>.json``, all starting them once every rank's
  profiler runs;
- the check: every follower sends its rows of what the check reads
  (``Session.rows``), and rank 0 assembles the whole accumulators
  (``assemble``) before its session checks them;
- once the check is done, every follower names the modules of
  ``FORBIDDEN`` that its process holds, and rank 0 refuses the run
  (``Forbidden``) where one names any.

The harness adds no collective on the device: those a run makes are the
program's own (a checkpoint save gathers the accumulator). A follower
that ends before it is told to, or that has not answered ``ANSWER_S``
seconds after rank 0 began to wait for it, ends the run: rank 0 raises
``WorldError`` and every follower is killed; so does a follower that
holds back a collective, once rank 0 has waited in a call for
``ANSWER_S`` seconds. A follower's traceback goes
to standard error, which it shares with rank 0, and so does anything it
prints, so that the last line of standard output stays rank 0's result.
Where rank 0 is stuck where it cannot raise (in a collective that a dead
rank will never join), its watchdog ends the process ``GRACE_S`` seconds
after it killed the followers.

What a test puts in place of the card in rank 0 (``port.BACKEND``,
``window.Clock``, ``spec.ROOT``, the cell itself) reaches the followers
as arguments of their process, since a change made in rank 0's modules
does not cross ``spawn``; and ``FOLLOWER_SETUP``, where a test sets it,
runs first in every follower, with the follower's rank.
"""

from __future__ import annotations

import gc
import multiprocessing
import multiprocessing.connection
import os
import socket
import sys
import threading
import time
import traceback

import torch

from benchmark.harness import spec, window
from benchmark.harness.inputs import make_inputs
from benchmark.harness.spec import load_module
from benchmark.harness.trace import traced

# seconds rank 0 waits for a follower's answer before it ends the run
ANSWER_S = 120.0
# seconds rank 0 has to stop after a follower ended before its watchdog
# ends the process
GRACE_S = 20.0
# a picklable callable(rank) that every follower runs first, or None
FOLLOWER_SETUP = None
# top-level module names that may not be loaded in any rank's process
# once the window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "cpuperformanceraytracer_tpu")


class WorldError(RuntimeError):
    """A follower ended, failed or did not answer in time."""


class Forbidden(WorldError):
    """A follower's process holds a forbidden module."""


def forbidden_modules() -> list:
    """The names of ``FORBIDDEN`` that this process has loaded, compared
    by whole top-level names."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def start(cell, seed: int, device, log):
    """The world of ``cell``: a ``Solo`` where it asks for one chip,
    else a ``World`` with its followers started and joined."""
    if cell.chips == 1:
        return Solo(device)
    return World(cell, seed, device, log)


class Solo:
    """A world of one: the session built and driven in this process."""

    size = 1
    # each follower's (peak bytes, device ms of each call) of the window
    drained = ()

    def __init__(self, device):
        self.device = device

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *exc) -> None:
        self.close(ended_well=exc_type is None)

    def close(self, ended_well: bool = True) -> None:
        pass

    def loaded(self) -> dict:
        """Each follower's ``forbidden_modules()``, where it has any."""
        return {}

    def session(self, kind, inputs, cell, seconds: float):
        """A session of ``kind`` (``benchmark/kinds/``) on every rank."""
        return kind.Session(inputs, cell, seconds, self.device)

    def traced(self, session, n: int, path) -> list:
        """Each rank's trace of ``n`` calls of ``session``, rank 0's to
        ``path``."""
        return [traced(session.call, n, path)]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _leaves(tree) -> list:
    """The tensors of a tree of dicts, lists and tuples, in order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _rebuild(tree, leaves):
    """``tree`` with its tensors taken in order from the iterator
    ``leaves``."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, leaves) for v in tree)
    return next(leaves)


def assemble(parts: list, shape: tuple) -> torch.Tensor:
    """The whole (3, H, W) tensor from each rank's (3, H / px, W) rows,
    on the device of rank 0's: rank r sits at (px, spp) = divmod(r, spp)
    and holds the rows of its "px" block, as the program's mesh places
    them. The ranks of a "spp" column hold the same rows; where one's
    differ from the column's first, those values are NaN, which the
    check counts as off."""
    n_px, n_spp = shape
    dev = parts[0].device
    blocks = []
    for p in range(n_px):
        column = [t.to(dev) for t in parts[p * n_spp:(p + 1) * n_spp]]
        block = column[0]
        for other in column[1:]:
            block = torch.where(other == block, block, float("nan"))
        blocks.append(block)
    return torch.cat(blocks, dim=-2)


class World(Solo):
    """Rank 0 of a world of ``cell.chips`` ranks, its followers started
    and joined; ``close`` (or the end of a ``with``) stops them."""

    def __init__(self, cell, seed: int, device, log):
        from benchmark.harness import port

        super().__init__(device)
        self.size, self.shape = cell.chips, cell.mesh
        self.drained = []
        self.failed = None
        self.links, self.procs = [], []
        self._closing = threading.Event()
        # while rank 0 makes calls the followers make too: when it last
        # told them anything; None otherwise
        self._driving = None
        port.load_kernels()
        own_cards = (device.type == "cuda"
                     and torch.cuda.device_count() >= self.size)
        backend = "nccl" if own_cards else "gloo"
        address = f"127.0.0.1:{_free_port()}"
        given = (port.BACKEND, window.Clock, spec.ROOT, FOLLOWER_SETUP)
        ctx = multiprocessing.get_context("spawn")
        for rank in range(1, self.size):
            here, there = ctx.Pipe()
            proc = ctx.Process(
                target=follow, name=f"benchmark-rank{rank}", daemon=True,
                args=(rank, self.size, address, backend, cell, seed,
                      device.type, given, there))
            proc.start()
            there.close()
            self.links.append(here)
            self.procs.append(proc)
        self._watchdog = threading.Thread(target=self._watch, daemon=True)
        self._watchdog.start()
        try:
            self.mesh = port.join_world(0, self.size, address, backend,
                                        self.shape, device)
        except BaseException:
            self.close(ended_well=False)
            raise
        log(f"world: {self.size} ranks over {backend}, mesh (px, spp) "
            f"{self.shape}")

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close(ended_well=exc_type is None)
        if self.failed and exc_type is not None and not issubclass(
                exc_type, WorldError):
            raise WorldError(self.failed) from exc

    @property
    def followers(self) -> range:
        return range(1, self.size)

    def _watch(self) -> None:
        """End the world once a follower has ended before it was told,
        or once rank 0, making calls the followers make too, has told
        them nothing for ``ANSWER_S`` seconds: it waits in a collective
        that some rank does not join."""
        while not self._closing.wait(0.2):
            ended = [(r, p.exitcode) for r, p in enumerate(self.procs, 1)
                     if p.exitcode is not None]
            since = self._driving
            if ended:
                self.failed = (f"rank {ended[0][0]} ended (exit code "
                               f"{ended[0][1]}) before the run did")
            elif since is not None and time.monotonic() - since > ANSWER_S:
                self.failed = (f"rank 0 has waited in a call for "
                               f"{ANSWER_S:.0f} s: a rank holds back a "
                               "collective")
            else:
                continue
            self._kill()
            if not self._closing.wait(GRACE_S):
                print(f"world: {self.failed}; rank 0 did not stop within "
                      f"{GRACE_S:.0f} s", file=sys.stderr, flush=True)
                os._exit(5)
            return

    def _kill(self) -> None:
        for p in self.procs:
            if p.is_alive():
                p.kill()

    def _raise_if_failed(self) -> None:
        if self.failed:
            raise WorldError(self.failed)

    def drive(self, on: bool) -> None:
        """Say whether rank 0 makes calls the followers make too."""
        self._driving = time.monotonic() if on else None

    def tell(self, rank: int, *msg) -> None:
        """Send ``msg`` to follower ``rank``."""
        self._raise_if_failed()
        if self._driving is not None:
            self._driving = time.monotonic()
        try:
            self.links[rank - 1].send(msg)
        except OSError as e:
            raise WorldError(f"rank {rank}: {e}") from e

    def send(self, *msg) -> None:
        """Send ``msg`` to every follower."""
        for r in self.followers:
            self.tell(r, *msg)

    def answer(self, rank: int):
        """The next message from follower ``rank``, waited for at most
        ``ANSWER_S`` seconds."""
        link = self.links[rank - 1]
        deadline = time.monotonic() + ANSWER_S
        while not link.poll(0.1):
            self._raise_if_failed()
            if time.monotonic() > deadline:
                raise WorldError(f"rank {rank} has not answered in "
                                 f"{ANSWER_S:.0f} s")
        try:
            return link.recv()
        except (EOFError, OSError) as e:
            self._raise_if_failed()
            raise WorldError(f"rank {rank} ended") from e

    def expect(self, rank: int, what: str) -> tuple:
        msg = self.answer(rank)
        if msg[0] != what:
            raise WorldError(f"rank {rank} answered {msg[0]!r}, not {what!r}")
        return msg

    def close(self, ended_well: bool = True) -> None:
        """Stop every follower (kill each where the run did not end
        well), wait until each has ended (killing any left after 30 s),
        and leave the world."""
        from benchmark.harness import port

        if self._closing.is_set():
            return
        self._closing.set()
        if not ended_well:
            self._kill()
        for link in self.links:
            try:
                link.send(("stop",))
            except OSError:
                pass
        deadline = time.monotonic() + 30.0
        for p in self.procs:
            p.join(max(0.0, deadline - time.monotonic()))
            if p.is_alive():
                p.kill()
                p.join()
        for link in self.links:
            link.close()
        self._watchdog.join()
        port.leave_world()

    def loaded(self) -> dict:
        self.send("modules")
        found = {r: self.expect(r, "modules")[1] for r in self.followers}
        return {r: names for r, names in found.items() if names}

    def session(self, kind, inputs, cell, seconds: float):
        self.send("session", seconds)
        local = kind.Session(inputs, cell, seconds, self.device,
                             mesh=self.mesh)
        for r in self.followers:
            self.expect(r, "ready")
        return Mirror(self, local, cell.traffic["calls_per_chunk"])

    def join_window(self) -> None:
        """Every follower drains its session and its card; their readings
        go to ``drained``."""
        self.send("drain")
        self.drained = [self.expect(r, "drained")[1:] for r in self.followers]

    def traced(self, session, n: int, path) -> list:
        paths = [path.with_suffix(f".rank{r}.json") for r in range(self.size)]
        for r in self.followers:
            self.tell(r, "traced", n, paths[r])

        def started():
            # every rank's profiler runs (the first start in a process
            # takes seconds) before any rank makes its first call
            for r in self.followers:
                self.expect(r, "profiling")
            self.drive(True)
            self.send("go")

        traces = [traced(session.local.call, n, paths[0], started)]
        self.drive(False)
        return traces + [self.expect(r, "traced")[1] for r in self.followers]

    def gather_rows(self, local) -> None:
        """Hand ``local`` (rank 0's session) the whole of what its check
        reads, assembled from every rank's rows."""
        mine = local.rows()
        leaves = _leaves(mine)
        self.send("rows")
        parts = [leaves]
        for r in self.followers:
            k = self.expect(r, "rows")[1]
            if k != len(leaves):
                raise WorldError(f"rank {r} kept {k} blocks of rows for the "
                                 f"check; rank 0 kept {len(leaves)}")
            parts.append([torch.from_numpy(self.answer(r)) for _ in range(k)])
        whole = [assemble([p[i] for p in parts], self.shape)
                 for i in range(len(leaves))]
        local.take_rows(_rebuild(mine, iter(whole)))


class Mirror(window.Session):
    """Rank 0's session of a world, whose calls and hooks every follower
    makes too: in the window a command a chunk, sent at its ``plan``
    before rank 0 makes the chunk's calls; outside it a command a call."""

    def __init__(self, world: World, local, chunk: int):
        self.world, self.local, self.chunk = world, local, chunk
        self.steps_per_call = local.steps_per_call
        self.windowed = False

    def plan(self, n: int, elapsed: float) -> None:
        self.windowed = True
        self.world.drive(True)
        self.world.send("chunk", n, elapsed, self.chunk)
        self.local.plan(n, elapsed)

    def before(self, n: int) -> None:
        self.local.before(n)

    def after(self, n: int) -> None:
        self.local.after(n)

    def pending(self) -> bool:
        return self.local.pending()

    def call(self) -> None:
        if self.windowed:
            self.local.call()
            return
        self.world.drive(True)
        self.world.send("call")
        self.local.call()
        self.world.drive(False)

    def drain(self) -> None:
        self.world.drive(False)
        self.local.drain()
        self.world.join_window()
        self.windowed = False

    def release(self) -> None:
        self.world.send("release")
        self.local.release()

    def check(self, inputs, cell, log):
        self.world.gather_rows(self.local)
        return self.local.check(inputs, cell, log)


def _end_with_rank_0() -> None:
    """End this follower once rank 0's process has ended."""
    multiprocessing.connection.wait([multiprocessing.parent_process().sentinel])
    os._exit(1)


def follow(rank, size, address, backend, cell, seed, device_type, given,
           link) -> None:
    """A follower's process: join the world, then serve rank 0's commands
    until it says stop. Any failure prints its traceback on standard error
    and ends the process with exit code 1."""
    os.dup2(2, 1)
    sys.stdout = sys.stderr
    threading.Thread(target=_end_with_rank_0, daemon=True).start()
    try:
        Follower(rank, size, address, backend, cell, seed, device_type,
                 given, link).serve()
    except BaseException:
        print(f"rank {rank} failed:", file=sys.stderr)
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)


class Follower:
    """Rank ``rank`` of a world: its inputs, its session, and the
    commands of rank 0 (``on_<command>``)."""

    def __init__(self, rank, size, address, backend, cell, seed, device_type,
                 given, link):
        from benchmark.harness import port

        self.port = port
        port.BACKEND, window.Clock, spec.ROOT, setup = given
        if setup is not None:
            setup(rank)
        self.cell, self.link = cell, link
        self.device = (torch.device("cuda", rank % torch.cuda.device_count())
                       if device_type == "cuda" else torch.device("cpu"))
        self.mesh = port.join_world(rank, size, address, backend, cell.mesh,
                                    self.device)
        self.inputs = make_inputs(cell, seed, self.device)
        self.kind = load_module("kinds", cell.traffic["kind"])
        self.session = None
        self.chunks = None

    def serve(self) -> None:
        while True:
            op, *args = self.link.recv()
            if op == "stop":
                self.port.leave_world()
                return
            getattr(self, f"on_{op}")(*args)

    def on_session(self, seconds: float) -> None:
        self.session = self.kind.Session(self.inputs, self.cell, seconds,
                                         self.device, mesh=self.mesh)
        window.sync(self.device)
        self.link.send(("ready",))

    def on_chunk(self, n: int, elapsed: float, count: int) -> None:
        """The chunk of ``count`` calls from call ``n``, as
        ``window.run_window`` makes it."""
        if self.chunks is None:
            self.chunks = window.Chunks(
                self.session, count, self.cell.traffic["chunks_in_flight"])
        self.chunks.run(n, elapsed)

    def on_drain(self) -> None:
        try:
            self.chunks.drain()
        finally:
            gc.enable()
        call_ms, self.chunks = self.chunks.call_ms(), None
        peak = (torch.cuda.max_memory_allocated(self.device)
                if self.device.type == "cuda" else 0)
        self.link.send(("drained", peak, call_ms))

    def on_modules(self) -> None:
        self.link.send(("modules", forbidden_modules()))

    def on_call(self) -> None:
        self.session.call()

    def on_traced(self, n: int, path) -> None:
        def started():
            self.link.send(("profiling",))
            op, = self.link.recv()
            if op != "go":
                raise RuntimeError(f"rank 0 said {op!r}, not 'go'")

        self.link.send(("traced", traced(self.session.call, n, path,
                                         started)))

    def on_release(self) -> None:
        self.session.release()
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def on_rows(self) -> None:
        """Send this rank's rows of what the check reads, a block at a
        time, then let the session go."""
        leaves = _leaves(self.session.rows())
        self.link.send(("rows", len(leaves)))
        for t in leaves:
            self.link.send(t.cpu().numpy())
        self.session = None
