"""The in-process group: k members of one mesh, each a thread with its own
device, meeting through device copies.

The counterpart of the reference's one-process mesh over every device JAX
sees (quickstep_tpu/parallel/mesh.py:20-23, exec/executor.py:83-87). Here
the mesh is spread over k members of one process: member i drives the
device `devices[i]` from a thread of its own, holds its local shards of
the global mesh, and is to this group what a rank is to a torch.distributed
group (parallel/multihost.py), so that the mesh's collectives
(parallel/mesh.py) reach the other members through `Member` where they
would reach the other processes through torch.distributed. Two members may
share a device.

An exchange is a deposit and a collect: each member leaves its send
tensor in its slot, meets the others at a barrier, copies what it
receives from their slots into its own buffers on its own device
(`copy_`, never a view: on a shared device a view would be the sender's
rows), and meets them at a second barrier, after which a slot may be
reused. On a card, a depositor records an event on its current stream,
which the reader's stream waits for before it copies; the reader records
one after its copies, which the depositor's stream waits for before it
runs on (and may reuse the deposit's memory). A member that raises aborts
the barrier (`abort`), so that the others raise BrokenBarrierError at
their next exchange instead of waiting out the timeout
(multihost.TIMEOUT).

Each member runs on a MemberThread, which sets it as its thread's
`current()` member (multihost.py answers for that member where one is
set) and, on a card, the member's card as the thread's current device,
once; `run_on_members` hands every member's thread a job at once and
waits for all of them.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, List, Optional, Sequence

import torch

_here = threading.local()


def current() -> Optional["Member"]:
    """The member this thread runs, or None."""
    return getattr(_here, "member", None)


def set_current(member: Optional["Member"]) -> None:
    _here.member = member


class LocalGroup:
    """k members over `devices` (one each, repeats allowed) and the
    barrier and slots they exchange through."""

    def __init__(self, devices: Sequence):
        from quickstep_tpu_torch.parallel.multihost import TIMEOUT
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("a group needs at least one member")
        if len({d.type for d in self.devices}) > 1:
            raise ValueError(f"members on devices of one kind, not "
                             f"{[str(d) for d in self.devices]}")
        self.size = len(self.devices)
        self._barrier = threading.Barrier(self.size,
                                          timeout=TIMEOUT.total_seconds())
        # each member's deposit and its event; each member's event after
        # its copies
        self._slots: List[Optional[tuple]] = [None] * self.size
        self._done: List[Optional[torch.cuda.Event]] = [None] * self.size
        self.members = [Member(self, r) for r in range(self.size)]

    def abort(self) -> None:
        """Break the barrier: every member waiting at it, or reaching it,
        raises BrokenBarrierError."""
        self._barrier.abort()

    def reset(self) -> None:
        """A fresh barrier and empty slots, once no member is inside an
        exchange (after a statement that raised)."""
        self._barrier.reset()
        self._slots = [None] * self.size
        self._done = [None] * self.size


class Member:
    """Member `rank` of a LocalGroup: the group a Mesh of that member takes
    (Mesh.world is the member count, Mesh.rank this index)."""

    def __init__(self, group: LocalGroup, rank: int):
        self.group = group
        self.rank = rank
        self.world = group.size
        self.device = group.devices[rank]

    def __repr__(self) -> str:
        return f"Member({self.rank} of {self.world} on {self.device})"

    def barrier(self) -> None:
        self.group._barrier.wait()

    def abort(self) -> None:
        self.group.abort()

    def _event(self):
        if self.device.type != "cuda":
            return None
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    def _deposit(self, payload) -> list:
        """Leave payload in this member's slot; after every member has,
        return every slot's (payload, event), in member order."""
        self.group._slots[self.rank] = (payload, self._event())
        self.barrier()
        got = list(self.group._slots)
        if self.device.type == "cuda":
            stream = torch.cuda.current_stream(self.device)
            for r, (_payload, ev) in enumerate(got):
                if r != self.rank:
                    stream.wait_event(ev)
        return got

    def _release(self) -> None:
        """After this member's copies: once every member has copied, the
        deposits may be reused (on a card, this member's stream waits for
        the others' copies)."""
        self.group._done[self.rank] = self._event()
        self.barrier()
        if self.device.type == "cuda":
            stream = torch.cuda.current_stream(self.device)
            for r, ev in enumerate(self.group._done):
                if r != self.rank:
                    stream.wait_event(ev)
        self.group._slots[self.rank] = None

    def all_gather(self, dst: torch.Tensor, src: torch.Tensor) -> None:
        """Row r of dst ([world, len(src)], on this member's device) gets
        member r's src."""
        for r, (t, _ev) in enumerate(self._deposit(src)):
            dst[r].copy_(t)
        self._release()

    def all_to_all(self, dst: torch.Tensor, send: torch.Tensor) -> None:
        """all_to_all_single of equal splits: row q of send ([world, R])
        goes to member q, and row q of dst came from member q."""
        for r, (t, _ev) in enumerate(self._deposit(send)):
            dst[r].copy_(t[self.rank])
        self._release()


class MemberThread:
    """The thread of one member, kept for its database's life: it takes the
    member as its thread's current member and, on a card, the member's card
    as its current device, once, then runs the jobs handed to it in order
    (run_on_members)."""

    def __init__(self, member: Member):
        self.member = member
        self._jobs: "queue.Queue" = queue.Queue()
        self.thread = threading.Thread(
            target=self._loop, daemon=True,
            name=f"qstpu-member-{member.rank}")
        self.thread.start()

    def _loop(self) -> None:
        set_current(self.member)
        if self.member.device.type == "cuda":
            torch.cuda.set_device(self.member.device)
        while True:
            job = self._jobs.get()
            if job is None:
                return
            job.run(self.member)

    def stop(self, timeout: Optional[float] = None) -> None:
        self._jobs.put(None)
        self.thread.join(timeout)


class _Job:
    def __init__(self, fn: Callable, arg):
        self.fn, self.arg = fn, arg
        self.result = self.error = None
        self.done = threading.Event()

    def run(self, member: Member) -> None:
        try:
            self.result = self.fn(self.arg)
        except BaseException as e:      # handed to the caller
            self.error = e
            # the others stop at their next exchange, not at the timeout
            member.abort()
        finally:
            self.done.set()


def run_on_members(threads: Sequence[MemberThread], fn: Callable,
                   args: Sequence) -> list:
    """fn(args[i]) on member i's thread, for every member at once; returns
    the results in member order once every member has returned. If any
    member raised, every member has stopped, the group is reset for the
    next call, and the first member's error that is not the broken barrier
    it left the others is raised."""
    jobs = [_Job(fn, a) for a in args]
    for t, job in zip(threads, jobs):
        t._jobs.put(job)
    for job in jobs:
        job.done.wait()
    errors = [job.error for job in jobs if job.error is not None]
    if errors:
        threads[0].member.group.reset()
        raise next((e for e in errors
                    if not isinstance(e, threading.BrokenBarrierError)),
                   errors[0])
    return [job.result for job in jobs]
