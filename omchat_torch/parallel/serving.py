"""Tensor-parallel serving across ranks, one process a rank, in lockstep.

The JAX package serves a mesh from one controller.  Here each rank of the
``model`` axis is its own process holding its shard of the weights and of
the KV cache, and every rank must make the same device calls in the same
order, or a collective waits forever.  Three pieces keep them together:

- :func:`check_serving_mesh`: what an engine takes under a mesh: a
  :class:`~omchat_torch.parallel.mesh.Mesh`, pure tensor-parallel (a data
  axis of 1, as JAX's serving mesh), with at least one q head on every
  rank.  Any tp up to the q heads serves (the kv heads replicate where tp
  does not divide them), and so do w8a8, a LoRA bank and the MoE trunk.
- :func:`agreed`: a host decision that only the leader (the first rank of
  the model axis) can take, or that must not differ between ranks (an
  ``allowed_tokens_fn`` mask, a stop-keyword check, a draft), is taken on
  the leader and broadcast; the other ranks receive it instead of calling
  their own function.  Decisions made from the tokens need nothing: the
  logits, and so the tokens, are bitwise the same on every rank
  (:func:`omchat_torch.models.qwen2.full_logits`), and the generators are
  seeded alike.
- :func:`replicated`, :func:`lead` and :func:`follow`: a server's leader
  owns the tokenizer, stdin and HTTP.  :func:`lead` gives its engines a
  channel; each public engine call (``generate``, ``submit``, ``step``,
  ``cancel``, ``pop_result``, ``precompile``, ...) is then broadcast, with
  its host inputs, to the followers before it runs on the leader, and the
  followers (:func:`follow`) replay it on their shards.  Callbacks that only
  observe (``stream_callback``, ``logits_callback``, ``score_callback``)
  and the tokenizer
  reach a follower as None; a callback that decides reaches it as
  :data:`FROM_LEADER`, which :func:`agreed` turns into a receive.  After
  every call the ranks exchange whether it raised: the same error on every
  rank (a refused request) is the leader's to report; an error on one side
  only raises :class:`ReplicaDiverged` on every rank, with the failed
  ranks' tracebacks, and a follower that raises exits, which ``torchrun``
  turns into the end of the world.

The command channel is a gloo group of its own with a timeout of days (an
idle follower waits in it); the model axis's collectives keep the world's
finite timeout, so a rank lost in the middle of a call ends the others'
wait too.
"""

from __future__ import annotations

import datetime
import functools
import logging
import threading
import traceback
from typing import Dict, Optional

import torch

logger = logging.getLogger("omchat_torch.serving")

# the keyword arguments that only observe a call: a follower gets None
OBSERVERS = ("stream_callback", "logits_callback", "score_callback", "tokenizer")
CHANNEL_TIMEOUT = datetime.timedelta(days=30)


class ReplicaDiverged(RuntimeError):
    """A replicated call raised on some ranks and not on others (or not
    alike): the ranks' states may differ, so serving cannot go on."""


class _FromLeader:
    """The marker a follower gets for a deciding callback: :func:`agreed`
    makes it receive the leader's decision."""

    def __call__(self, *args, **kw):
        raise RuntimeError("a callback that only the leading rank holds was called outside agreed()")

    def __reduce__(self):
        return (_from_leader, ())

    def __repr__(self) -> str:
        return "FROM_LEADER"


def _from_leader():
    return FROM_LEADER


FROM_LEADER = _FromLeader()


def check_serving_mesh(cfg, mesh, *, what: str = "engine") -> None:
    """Refuse what a serving engine cannot run under ``mesh`` (nothing
    without one): anything but a :class:`Mesh`, a data axis above 1, and a
    tp that would leave a rank without a q head of the trunk or of the
    vision tower (the JAX package pads such a rank out)."""
    if mesh is None:
        return
    from omchat_torch.parallel.mesh import Mesh
    from omchat_torch.parallel.sharding import check_trunk_tp

    if not isinstance(mesh, Mesh):
        raise TypeError(f"{what}: mesh must be an omchat_torch.parallel.mesh.Mesh, not {type(mesh).__name__}")
    if "model" not in mesh.axis_names or any(n != 1 for a, n in mesh.shape.items() if a != "model"):
        raise ValueError(f"{what}: a serving mesh is pure tensor-parallel (JAX's serving mesh has no data axis), "
                         f"got {mesh.shape}")
    tp = mesh.axis_size("model")
    try:
        check_trunk_tp(cfg.text, tp)
    except ValueError as e:
        raise ValueError(f"{what}: {e}") from None
    if tp > cfg.vision.num_attention_heads:
        raise ValueError(f"{what}: tp={tp} would leave a rank without a q head of the vision tower (it has "
                         f"{cfg.vision.num_attention_heads})")


def serving_mesh(tp: int):
    """The pure tensor-parallel mesh of ``tp`` ranks over the launched world
    (None at tp 1), which must be exactly ``tp`` ranks."""
    if tp <= 1:
        return None
    from omchat_torch.parallel.mesh import _world, create_mesh

    world = _world()[0]
    if world != tp:
        raise ValueError(f"tp={tp} serves over a launched world of exactly {tp} ranks (torchrun --nproc-per-node "
                         f"{tp}); this world has {world}")
    return create_mesh(tp=tp)


def _leader_rank(mesh) -> int:
    """The global rank of the first rank of this rank's model axis."""
    return int(mesh.grid[mesh.axis_index("data"), 0]) if "data" in mesh.axis_names else int(mesh.grid.flat[0])


def agreed(mesh, fn):
    """``fn`` as every rank of the model axis takes it: itself without a
    mesh or at tp 1; else a callable that calls ``fn`` on the leader and
    broadcasts the result, and on any other rank receives it (its own
    ``fn``, which may be :data:`FROM_LEADER`, is not called).  Every rank
    must call it the same number of times.  None stays None."""
    if fn is None or mesh is None or mesh.axis_size("model") == 1:
        return fn
    import torch.distributed as dist

    group, src = mesh.group("model"), _leader_rank(mesh)
    first = mesh.axis_index("model") == 0

    def call(*args, **kw):
        box = [fn(*args, **kw) if first else None]
        dist.broadcast_object_list(box, src=src, group=group)
        return box[0]

    return call


_INSIDE = threading.local()  # a replicated call is running on this thread: nested calls run locally


def replicated(method):
    """A public engine call that a leader's channel (:func:`lead`)
    broadcasts to the followers before running it; an engine without a
    channel, and any call made inside a replicated call, runs as it is."""

    @functools.wraps(method)
    def call(self, *args, **kw):
        channel = getattr(self, "_channel", None)
        if channel is None or getattr(_INSIDE, "active", False):
            return method(self, *args, **kw)
        return channel.run(self, method, args, kw)

    return call


def _marshal_value(name, value):
    if name in OBSERVERS:
        return None
    if isinstance(value, torch.Generator):
        from omchat_torch.runtime.generate import seed_of

        return seed_of(value)
    if callable(value) and not isinstance(value, type):
        return FROM_LEADER
    return value


def _summary(err: BaseException) -> str:
    return f"{type(err).__name__}: {err}"


class _Channel:
    """The command channel over the model axis: a gloo group of its own
    (created collectively by :func:`lead` and :func:`follow`)."""

    def __init__(self, mesh):
        import torch.distributed as dist

        self.mesh = mesh
        self.src = _leader_rank(mesh)
        members = [int(r) for r in mesh.grid[mesh.axis_index("data")]]
        self.group = dist.new_group(members, timeout=CHANNEL_TIMEOUT, backend="gloo")

    def send(self, msg):
        import torch.distributed as dist

        dist.broadcast_object_list([msg], src=self.src, group=self.group)

    def recv(self):
        import torch.distributed as dist

        box = [None]
        dist.broadcast_object_list(box, src=self.src, group=self.group)
        return box[0]

    def exchange(self, status) -> list:
        """Every rank's (ok, error summary, traceback), in rank order."""
        import torch.distributed as dist

        out = [None] * self.mesh.axis_size("model")
        dist.all_gather_object(out, status, group=self.group)
        return out


class _Leader(_Channel):
    def __init__(self, mesh, engines: Dict[str, object]):
        super().__init__(mesh)
        self.names = {id(e): n for n, e in engines.items()}
        self.lock = threading.Lock()

    def run(self, engine, method, args, kw):
        with self.lock:
            self.send(("call", self.names[id(engine)], method.__name__,
                       tuple(_marshal_value(None, a) for a in args),
                       {k: _marshal_value(k, v) for k, v in kw.items()}))
            err, result, status = None, None, (True, None, None)
            _INSIDE.active = True
            try:
                result = method(engine, *args, **kw)
            except Exception as e:  # noqa: BLE001 — compared with the followers' outcome below
                err, status = e, (False, _summary(e), traceback.format_exc())
            finally:
                _INSIDE.active = False
            statuses = self.exchange(status)
            _judge(statuses, 0)
            if err is not None:
                raise err
            return result

    def stop(self):
        with self.lock:
            self.send(("stop",))


def _judge(statuses: list, me: int) -> None:
    """Raise :class:`ReplicaDiverged` unless every rank ended its call
    alike (all fine, or all with the same error)."""
    if len({(ok, summary) for ok, summary, _ in statuses}) == 1:
        return
    failed = "\n".join(f"--- rank {r}: {summary}\n{tb or ''}" for r, (ok, summary, tb) in enumerate(statuses) if not ok)
    raise ReplicaDiverged(f"a replicated call ended differently on the model axis's ranks (this is rank {me}):\n"
                          f"{failed}")


def lead(mesh, **engines) -> Optional[_Leader]:
    """Make this (first) rank the leader of ``engines`` ({name: engine},
    the same names the followers give :func:`follow`): their replicated
    calls are broadcast from now on.  Returns the channel (its ``stop()``
    releases the followers), or None at tp 1."""
    if mesh is None or mesh.axis_size("model") == 1:
        return None
    if mesh.axis_index("model") != 0:
        raise ValueError("lead() runs on the model axis's first rank; the others follow()")
    channel = _Leader(mesh, engines)
    for engine in engines.values():
        if engine is not None:
            engine._channel = channel
    return channel


def follow(mesh, **engines) -> None:
    """Replay the leader's calls on this rank's ``engines`` until the
    leader stops.  A call that raises here and not alike on the leader
    raises :class:`ReplicaDiverged` (with this rank's traceback) out of
    this function."""
    channel = _Channel(mesh)
    me = mesh.axis_index("model")
    while True:
        msg = channel.recv()
        if msg[0] == "stop":
            return
        _, name, method, args, kw = msg
        status = (True, None, None)
        try:
            getattr(engines[name], method)(*args, **kw)
        except Exception as e:  # noqa: BLE001 — compared with the leader's outcome
            status = (False, _summary(e), traceback.format_exc())
            logger.error("rank %d: replicated %s.%s raised:\n%s", mesh.rank, name, method, status[2])
        _judge(channel.exchange(status), me)
