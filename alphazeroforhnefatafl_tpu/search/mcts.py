"""On-device batched MCTS.

Array re-design of the reference's AlphaZero MCTS (``src/mcts.py``, the
working Python version; ``src/mcts.rs`` is a non-compiling sketch of the same
algorithm). The recursive, dict-keyed search inverts into an iterative
array-tree program: a batch of B independent trees advances in lockstep, one
leaf per tree per simulation, with a single fused NN forward over all B
leaves per wave — everything inside one ``lax.scan`` under jit.

Semantics preserved from the reference (cited into ``src/mcts.py``):

- PUCT selection ``u = Q + cpuct * P * sqrt(Ns + EPS) / (1 + Nsa)`` with
  ``Q = 0`` for unvisited edges (``mcts.py:109-121``; the visited/unvisited
  formulas there coincide in this single expression).
- Leaf expansion: NN priors masked to legal actions and renormalized, with a
  uniform-over-legal fallback when everything masks to zero
  (``mcts.py:83-102``).
- Negamax values: a leaf/terminal value is from the perspective of that
  node's player to move and flips sign at every step up the path
  (``mcts.py:67-69, 125-136``).
- Incremental backup ``Q = (N*Q + v) / (N + 1)`` as running sums W/N
  (``mcts.py:127-135``); ``Ns`` incremented on interior path nodes only
  (``mcts.py:135``).
- Visit-count action probabilities with temperature, argmax one-hot with
  random tie-break at ``temp == 0`` (``mcts.py:28-53``).

Deliberate deviations, both standard for scale:

- Each tree node keeps at most ``max_children`` candidate actions — the
  highest-prior legal moves (action subsampling). With the default 128 this
  is exact for all but the widest tafl positions.
- Nodes are a tree, not the reference's transposition-merged hash map: two
  move orders reaching the same position get separate nodes.

Dirichlet root noise (AlphaZero-standard, absent from the reference's MCTS)
is available for self-play exploration.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Tuple

import jax
import jax.numpy as jnp

from ..core.env import EnvState, TaflEnv
from ..utils.pytree import pytree_dataclass

EPS = 1e-8  # src/mcts.py:6
NEG_INF = jnp.float32(-1e30)


@dataclass(frozen=True)
class MCTSConfig:
    num_simulations: int = 128
    max_children: int = 128
    cpuct: float = 1.5  # args.cpuct in src/mcts.py:112
    dirichlet_alpha: float = 0.3
    #: When set, per-position alpha = dirichlet_alpha_scale / num_legal_moves
    #: (AlphaZero practice scales alpha inversely with branching factor; ~10
    #: gives alpha ~0.1 for tafl's ~100-move positions), overriding
    #: ``dirichlet_alpha``.
    dirichlet_alpha_scale: "float | None" = None
    dirichlet_eps: float = 0.25  # 0 disables root noise
    #: Path-buffer bound; traversals past it are treated as leaves. Tafl
    #: searches rarely exceed ~30 plies; the backup's one-hot path tensor is
    #: [B, max_depth, M], so keep this tight.
    max_depth: int = 64
    #: Tree levels advanced per traversal while-loop iteration. The
    #: traversal's trip count is data-dependent, so each iteration carries
    #: a loop-control cost of its own; unrolling U masked levels per
    #: iteration divides the number of iterations by ~U.
    traverse_unroll: int = 4
    #: Negamax backup form: "dense" (one-hot einsum over [B, M, K]),
    #: "scatter" (one fused scatter-add over the [B, D] path indices), or
    #: "auto" (dense). Both produce identical trees (tested); which is
    #: faster on the GPU is not measured yet.
    backup: str = "auto"
    #: Node-state fetch strategy for the per-wave tree reads: "gather"
    #: (one B-index ROW gather of the packed f32 state row, M-independent),
    #: "dot" (one-hot [1, M] x [M, P] matmul — streams the whole packed
    #: buffer every wave), or "auto" (dot). Both are exact; which is faster
    #: on the GPU is not measured yet.
    node_read: str = "auto"
    #: Root action selection: "puct" (the reference's scheme with optional
    #: Dirichlet noise) or "gumbel" (Gumbel top-m + sequential halving with
    #: completed Q-values, Danihelka et al. 2022 — more strength per
    #: simulation at the 64-128 sim budgets the training loop uses;
    #: interior selection stays PUCT). With "gumbel", play the returned
    #: ``best_action`` (exploration comes from the sampled Gumbels, not a
    #: temperature), and ``action_probs`` is the improved policy
    #: ``softmax(logits + sigma(completed Q))`` — the training target.
    root_selection: str = "puct"
    gumbel_considered: int = 16  # max root candidates entering halving
    gumbel_cvisit: float = 50.0  # sigma(q) = (cvisit + max_N) * cscale * q
    gumbel_cscale: float = 1.0
    #: Leaves expanded per tree per simulation wave (PUCT only). Each wave
    #: pays FIXED streams of the [B, M, K] stat buffers (dense backup
    #: einsums, child_node link write), so running L virtual-loss traversals per wave and
    #: fusing their env steps / NN forwards / backups pays those streams once
    #: per L simulations. 1 = the exact serial-equivalent search (the
    #: differential-tested reference semantics); >1 is the standard
    #: virtual-loss parallelization (a documented deviation: within a wave,
    #: later traversals see +vl/-vl pseudo-visits on earlier paths, and a
    #: traversal landing on an already-claimed edge re-evaluates that child
    #: instead of descending into it). Must divide num_simulations.
    leaves_per_wave: int = 1
    #: Virtual-loss weight: pending traversals count as this many losses on
    #: their path edges during intra-wave selection. Head-to-head A/Bs with
    #: a trained 11x11 net at 128 sims (runs/search_ab_r5.jsonl) measured a
    #: U-shape: 1.0 diverts so much budget off the principal variation that
    #: L=2 loses ~700 Elo to the serial search; 0.0 (pure virtual VISITS)
    #: loses ~137; 0.25 loses ~66 — the measured sweet spot and the
    #: default. The penalty shrinks with the simulation budget (the PV keeps
    #: proportionally more visits at 800 sims than at 128).
    virtual_loss: float = 0.25


@pytree_dataclass
class Tree:
    """Array-tree for one game's search (batched with a leading B axis).

    ``M = num_simulations + 1`` node slots, ``K = max_children`` edge slots.

    Stat layout: traversal reads stats per LEVEL, so they live in
    (node, slot)-keyed [M, K] buffers reachable with B-index row gathers
    rather than per-element [B, K]-index gathers. The reference's ``Ns``
    needs no buffer of its own: every interior pass takes exactly one edge,
    so ``Ns(node) == sum_k Nsa(node, k)`` and it is recomputed from the
    gathered stat row at selection time.

    Node ENV STATE lives in one packed f32 row per node (``_pack_state``):
    every per-wave state fetch is then a single wide row read instead of a
    per-field sweep — O(1) reads under ``node_read="gather"``, and a single
    [1, M] x [M, P] matmul under ``"dot"``. All fields hold small integers
    (the largest, an encoded play record, is < 2^18 at 21x21), so f32 is
    exact.
    """

    state_packed: jax.Array  # f32[M, P] packed EnvState rows (_pack_state)
    expanded: jax.Array  # bool[M]
    terminal: jax.Array  # bool[M]
    terminal_value: jax.Array  # f32[M] value from node-mover's perspective
    child_action: jax.Array  # i32[M, K], -1 = empty slot
    child_prior: jax.Array  # f32[M, K]
    child_N: jax.Array  # i32[M, K]  (Nsa)
    child_W: jax.Array  # f32[M, K]  (sum of backed-up values, node-mover persp.)
    child_node: jax.Array  # i32[M, K], -1 = not yet materialized
    n_nodes: jax.Array  # i32 allocated slots (one per wave; some unlinked)


@pytree_dataclass
class SearchResult:
    action_probs: jax.Array  # f32[B, A] visit-count (puct) / improved (gumbel) policy
    root_value: jax.Array  # f32[B] mean root value (mover perspective)
    root_visits: jax.Array  # i32[B]
    best_action: jax.Array  # i32[B] action to play (gumbel: the halving winner)
    #: f32[B]: fraction of this search's CONSUMED prior computations (root +
    #: each expanded leaf) where the legal-masked NN policy summed to zero and
    #: the uniform-over-legal fallback fired — the event the reference logs as
    #: its one error (src/mcts.py:96); SURVEY §5 says to count it as a metric.
    prior_fallback_rate: jax.Array
    tree: Any  # final Tree (batched), for inspection/reuse


def terminal_value(state: EnvState) -> jax.Array:
    """Value of a terminal state from the perspective of its player to move
    (``getGameEnded(board, 1)`` convention, ``src/mcts.py:77-81``)."""
    side = state.side_to_play
    return jnp.where(
        state.result == side,
        1.0,
        jnp.where(state.result == (1 - side), -1.0, 0.0),
    ).astype(jnp.float32)


def _sh_considered_schedule(sims: int, m0: int) -> list:
    """Sequential-halving schedule: entry w = size of the considered root
    candidate set at simulation w. ~log2(m0) equal-budget phases, candidates
    halving between phases, leftover simulations spent on the final
    two-candidate phase; the per-wave "least-visited among considered" rule
    spreads each phase's budget evenly over its candidates."""
    if m0 <= 1:
        return [1] * sims
    phases = max(1, math.ceil(math.log2(m0)))
    base = sims // phases
    out = []
    m = m0
    for p in range(phases):
        budget = base if p < phases - 1 else sims - base * (phases - 1)
        out.extend([m] * budget)
        m = max(2, m // 2)
    while len(out) < sims:
        out.append(2)
    return out[:sims]


#: The single source of truth for the packed node-state row layout: the
#: scalar fields following the n*n board cells, as (EnvState field, width,
#: unpack dtype) in row order. ``_pack_width`` / ``_pack_state`` /
#: ``_unpack_state`` and the observe-field offsets are ALL derived from this
#: table, so reordering or adding a field is a one-line change.
_SCALAR_LAYOUT = (
    ("side_to_play", 1, jnp.int32),
    ("recent_plays", 4, jnp.int32),
    ("rep_first_i", 1, jnp.int32),
    ("reps", 2, jnp.int32),
    ("mid_pair", 2, jnp.bool_),
    ("plays_since_capture", 1, jnp.int32),
    ("turn", 1, jnp.int32),
    ("terminated", 1, jnp.bool_),
    ("result", 1, jnp.int32),
    ("reason", 1, jnp.int32),
)


def _scalar_offsets(n: int):
    """Map field name -> (row offset, width, dtype) for an n x n board."""
    off, out = n * n, {}
    for name, w, dt in _SCALAR_LAYOUT:
        out[name] = (off, w, dt)
        off += w
    return out


def _pack_width(n: int) -> int:
    """Row width of the packed node-state buffer for an ``n`` x ``n`` board:
    board cells + the :data:`_SCALAR_LAYOUT` slots."""
    return n * n + sum(w for _, w, _ in _SCALAR_LAYOUT)


def _pack_state(state: EnvState) -> jax.Array:
    """Flatten one game's EnvState into an f32[P] row (unbatched leaves).

    Exact: every field is a small integer; the widest, an encoded play
    record ``side + 2*cap + 4*action``, stays < 2^18 even at 21x21 — far
    inside f32's 2^24 integer range.
    """
    f = jnp.float32
    parts = [state.board.reshape(-1).astype(f)]
    for name, w, _ in _SCALAR_LAYOUT:
        parts.append(jnp.asarray(getattr(state, name)).reshape(w).astype(f))
    return jnp.concatenate(parts)


def _unpack_state(row: jax.Array, n: int) -> EnvState:
    """Inverse of :func:`_pack_state` for one f32[P] row."""
    offs = _scalar_offsets(n)

    def take(name):
        o, w, dt = offs[name]
        return (row[o : o + w] if w > 1 else row[o]).astype(dt)

    return EnvState(
        board=row[: n * n].reshape(n, n).astype(jnp.int8),
        **{name: take(name) for name, _, _ in _SCALAR_LAYOUT},
    )


def _masked_priors_fb(
    logits: jax.Array, legal: jax.Array
) -> Tuple[jax.Array, jax.Array]:
    """Legal-masked, renormalized priors with uniform fallback
    (``src/mcts.py:83-102``); also returns ``fell_back: bool[B]`` — True where
    everything masked to zero and the uniform fallback fired (the condition
    the reference logs at ``src/mcts.py:96``)."""
    masked = jnp.where(legal, logits, NEG_INF)
    p = jax.nn.softmax(masked, axis=-1) * legal
    total = jnp.sum(p, axis=-1, keepdims=True)
    n_legal = jnp.maximum(jnp.sum(legal, axis=-1, keepdims=True), 1)
    fell_back = total[..., 0] <= 0
    return (
        jnp.where(total > 0, p / jnp.maximum(total, 1e-30), legal / n_legal),
        fell_back,
    )


def _masked_priors(logits: jax.Array, legal: jax.Array) -> jax.Array:
    """Priors only (see :func:`_masked_priors_fb`)."""
    return _masked_priors_fb(logits, legal)[0]


class MCTS:
    """Batched MCTS driver bound to an env and an evaluation function.

    ``evaluate(params, obs[B, N, N, C]) -> (logits[B, A], value[B])`` is the
    NN boundary (``nnet.predict``, ``src/mcts.py:85``).
    """

    def __init__(
        self,
        env: TaflEnv,
        evaluate: Callable,
        config: MCTSConfig,
    ):
        self.env = env
        self.evaluate = evaluate
        self.config = config
        self.num_nodes = config.num_simulations + 1
        # Guard every string-mode knob up front: with auto->dot dispatch a
        # typo like "gahter" would otherwise silently fall through to the
        # non-default branch (round-3 advisor finding).
        for field, allowed in (
            ("node_read", {"auto", "gather", "dot"}),
            ("backup", {"auto", "dense", "scatter"}),
            ("root_selection", {"puct", "gumbel"}),
        ):
            val = getattr(config, field)
            if val not in allowed:
                raise ValueError(
                    f"MCTSConfig.{field}={val!r}; expected one of {sorted(allowed)}"
                )
        L = config.leaves_per_wave
        if L < 1:
            raise ValueError(f"leaves_per_wave={L}; must be >= 1")
        if L > 1:
            if config.root_selection == "gumbel":
                raise ValueError(
                    "leaves_per_wave > 1 is a PUCT-only optimization (the "
                    "gumbel halving schedule forces one root slot per "
                    "simulation)"
                )
            if config.num_simulations % L:
                raise ValueError(
                    f"num_simulations={config.num_simulations} must be a "
                    f"multiple of leaves_per_wave={L}"
                )
        self._node_gather = config.node_read == "gather"

    def _topk(self, priors: jax.Array) -> Tuple[jax.Array, jax.Array]:
        """Exact top-``max_children`` priors and their actions."""
        return jax.lax.top_k(priors, self.config.max_children)

    # -------------------- tree construction --------------------

    def _empty_tree(self, root_state: EnvState) -> Tree:
        """Single-game empty tree with the root state in slot 0."""
        M, K = self.num_nodes, self.config.max_children
        return Tree(
            state_packed=jnp.broadcast_to(
                _pack_state(root_state), (M, _pack_width(self.env.n))
            ),
            expanded=jnp.zeros((M,), bool),
            terminal=jnp.zeros((M,), bool).at[0].set(root_state.terminated),
            terminal_value=jnp.zeros((M,), jnp.float32)
            .at[0]
            .set(terminal_value(root_state)),
            child_action=jnp.full((M, K), -1, jnp.int32),
            child_prior=jnp.zeros((M, K), jnp.float32),
            child_N=jnp.zeros((M, K), jnp.int32),
            child_W=jnp.zeros((M, K), jnp.float32),
            child_node=jnp.full((M, K), -1, jnp.int32),
            n_nodes=jnp.int32(1),
        )

    def _expand_node(self, tree: Tree, node: jax.Array, priors: jax.Array) -> Tree:
        """Store the top-K prior actions as the node's candidate edges."""
        top_p, top_a = self._topk(priors)
        has_mass = top_p > 0
        top_a = jnp.where(has_mass, top_a, -1)
        top_p = jnp.where(has_mass, top_p, 0.0)
        return tree.replace(
            expanded=tree.expanded.at[node].set(True),
            child_action=tree.child_action.at[node].set(top_a.astype(jnp.int32)),
            child_prior=tree.child_prior.at[node].set(top_p),
        )

    # -------------------- selection --------------------

    def _select_slot(self, tree: Tree, node: jax.Array, vn=None) -> jax.Array:
        """PUCT argmax over the node's edge slots (``src/mcts.py:109-121``).

        All reads are B-index row gathers of the [M, K] stat buffers (see
        the Tree docstring). ``vn`` (f32[K],
        multi-leaf waves only): virtual visit counts from this wave's pending
        traversals — each counts as ``virtual_loss`` losses on its edges.
        The ``vn is None`` branch is kept integer-exact so single-leaf
        searches stay bit-identical to the reference semantics.
        """
        N = tree.child_N[node]
        W = tree.child_W[node]
        P = tree.child_prior[node]
        if vn is None:
            Ns = jnp.sum(N).astype(jnp.float32)  # Ns == sum of edge visits
            Q = jnp.where(N > 0, W / jnp.maximum(N, 1), 0.0)
            u = Q + self.config.cpuct * P * jnp.sqrt(Ns + EPS) / (1.0 + N)
        else:
            Nf = N.astype(jnp.float32) + vn
            Wf = W - self.config.virtual_loss * vn
            Ns = jnp.sum(Nf)
            Q = jnp.where(Nf > 0, Wf / jnp.maximum(Nf, 1.0), 0.0)
            u = Q + self.config.cpuct * P * jnp.sqrt(Ns + EPS) / (1.0 + Nf)
        u = jnp.where(tree.child_action[node] >= 0, u, NEG_INF)
        return jnp.argmax(u).astype(jnp.int32)

    def _traverse(
        self, tree: Tree, forced_root_slot: jax.Array, prev_nodes=None,
        prev_slots=None,
    ):
        """Walk from the root to a leaf edge without stepping the env.

        ``forced_root_slot``: edge slot to take at the root, or -1 for PUCT
        (the Gumbel sequential-halving driver forces root candidates).
        ``prev_nodes``/``prev_slots`` (i32[Lp, D], multi-leaf waves only):
        the paths of this wave's earlier traversals; each on-path (node,
        slot) hit contributes one virtual visit to selection at that node.

        Returns (path_nodes, path_slots, depth, leaf_parent, leaf_slot,
        at_node_leaf, leaf_node): ``at_node_leaf`` means the walk stopped at
        an unexpanded-or-terminal node (no new edge); otherwise it stopped at
        an unmaterialized edge (child_node == -1).
        """
        D = self.config.max_depth
        K = self.config.max_children
        path_nodes = jnp.full((D,), -1, jnp.int32)
        path_slots = jnp.full((D,), -1, jnp.int32)
        use_vl = prev_nodes is not None and prev_nodes.shape[0] > 0

        def cond(c):
            return ~c["done"]

        def level(c):
            """Advance one tree level; a no-op once the walk is done."""
            node = c["node"]
            is_leaf_node = ~tree.expanded[node] | tree.terminal[node]

            if use_vl:
                # Virtual counts at this node from the wave's pending paths:
                # off-path entries hold node -1 and never match. Tiny
                # [Lp*D] x [Lp*D, K] contraction — no big-buffer traffic.
                match = (prev_nodes == node).astype(jnp.float32)  # [Lp, D]
                onehot = (
                    prev_slots[..., None] == jnp.arange(K)
                ).astype(jnp.float32)  # [Lp, D, K]
                vn = jnp.einsum("ld,ldk->k", match, onehot)
                slot = self._select_slot(tree, node, vn)
            else:
                slot = self._select_slot(tree, node)
            # Node 0 is only ever visited as the root.
            slot = jnp.where(
                (node == 0) & (forced_root_slot >= 0), forced_root_slot, slot
            )
            child = tree.child_node[node, slot]
            hit_edge = ~is_leaf_node & (child < 0)
            descend = ~is_leaf_node & (child >= 0)
            # Depth cap: treat as node leaf to keep the path buffer bounded.
            depth_capped = c["depth"] >= D - 1

            record = ~is_leaf_node
            d = c["depth"]
            path_nodes = c["path_nodes"].at[d].set(
                jnp.where(record, node, c["path_nodes"][d])
            )
            path_slots = c["path_slots"].at[d].set(
                jnp.where(record, slot, c["path_slots"][d])
            )
            new_depth = c["depth"] + record.astype(jnp.int32)

            done = is_leaf_node | hit_edge | (descend & depth_capped)
            new = {
                "node": jnp.where(descend, child, node),
                "depth": new_depth,
                "done": done,
                "at_node_leaf": is_leaf_node | (descend & depth_capped),
                "leaf_parent": jnp.where(hit_edge, node, c["leaf_parent"]),
                "leaf_slot": jnp.where(hit_edge, slot, c["leaf_slot"]),
                "path_nodes": path_nodes,
                "path_slots": path_slots,
            }
            was_done = c["done"]
            return {k: jnp.where(was_done, c[k], v) for k, v in new.items()}

        def body(c):
            # Advance several masked levels per while-loop iteration
            # (MCTSConfig.traverse_unroll).
            for _ in range(max(1, self.config.traverse_unroll)):
                c = level(c)
            return c

        init = {
            "node": jnp.int32(0),
            "depth": jnp.int32(0),
            "done": jnp.asarray(False),
            "at_node_leaf": jnp.asarray(False),
            "leaf_parent": jnp.int32(0),
            "leaf_slot": jnp.int32(0),
            "path_nodes": path_nodes,
            "path_slots": path_slots,
        }
        out = jax.lax.while_loop(cond, body, init)
        return out

    # -------------------- one simulation wave --------------------

    def _node_row(self, tree: Tree, node: jax.Array) -> jax.Array:
        """Per-game packed state row of ``node`` (f32[P]).

        ``node_read="gather"``: one B-index ROW gather (same form as the
        traversal's [M, K] stat-row reads), M-independent. ``"dot"``: one-hot
        [1, M] x [M, P] matmul — streams the whole packed buffer (O(M)
        memory traffic per wave) on the matrix units. Both are exact (f32
        integer math).
        """
        if self._node_gather:
            return tree.state_packed[node]
        M = tree.state_packed.shape[0]
        onehot = (jnp.arange(M) == node).astype(jnp.float32)[None, :]  # [1, M]
        return jnp.matmul(
            onehot, tree.state_packed, preferred_element_type=jnp.float32
        )[0]

    def _take_node_state(self, tree: Tree, node: jax.Array) -> EnvState:
        """Per-game full node-state read: one packed-row fetch + unpack."""
        return _unpack_state(self._node_row(tree, node), self.env.n)

    @staticmethod
    def _observe_fields_from_row(row: jax.Array, n: int):
        """Per-game (board, side_to_play, reps) — the only EnvState fields
        ``TaflEnv.observe`` reads — sliced from an already-fetched packed
        row (no extra buffer traffic)."""
        offs = _scalar_offsets(n)
        side_o, _, _ = offs["side_to_play"]
        reps_o, reps_w, _ = offs["reps"]
        return (
            row[: n * n].reshape(n, n).astype(jnp.int8),
            row[side_o].astype(jnp.int32),
            row[reps_o : reps_o + reps_w].astype(jnp.int32),
        )

    def _gather_action(self, tree: Tree, t):
        """Per-game: the traversal's leaf-edge action.

        [M, K] int32 row gather, the same form as the traversal's
        stat-row reads.
        """
        parent, slot = t["leaf_parent"], t["leaf_slot"]
        K = self.config.max_children
        row = tree.child_action[parent]  # [K]
        action = jnp.sum(row * (jnp.arange(K) == slot)).astype(jnp.int32)
        return jnp.maximum(action, 0)

    def _materialize_batched(self, tree, t, child_state: EnvState, new_idx):
        """Batched phase 1b: write the stepped children into node slot
        ``new_idx`` and return (updated tree, leaf node indices ``[B]``).

        One node slot is force-allocated per wave for EVERY game — the write
        index is a batch-uniform scalar, so node-state writes are single
        dynamic slice updates instead of batched scatters / one-hot sweeps
        over the whole [B, M, ...] buffers (whose traffic scaled with the
        simulation count). Games whose traversal ended at a terminal or
        depth-capped node simply leave their slot unlinked and unreachable;
        the slot budget (M = num_simulations + 1) is unchanged.
        """
        at_node_leaf = t["at_node_leaf"]  # [B]
        make_new = ~at_node_leaf

        def wr(buf, val):
            cur = jax.lax.dynamic_index_in_dim(buf, new_idx, 1, keepdims=False)
            m = make_new.reshape((-1,) + (1,) * (val.ndim - 1))
            return jax.lax.dynamic_update_index_in_dim(
                buf, jnp.where(m, val, cur), new_idx, 1
            )

        state_packed = wr(tree.state_packed, jax.vmap(_pack_state)(child_state))
        terminal = wr(tree.terminal, child_state.terminated)
        tvals = jax.vmap(terminal_value)(child_state)
        tval_buf = wr(tree.terminal_value, tvals)
        # The parent->child link is per-game (parent, slot). Two forms:
        # "scatter" is a B-index scatter-add (unmaterialized links hold -1;
        # adding new_idx + 1 sets them to new_idx; masked games add 0 at
        # their clamped index). The default dense one-hot masked write
        # streams the [B, M, K] buffer once.
        if self.config.backup == "scatter":
            b_ids = jnp.arange(t["leaf_parent"].shape[0])
            delta = jnp.where(make_new, new_idx + 1, 0)
            child_node = tree.child_node.at[
                b_ids,
                jnp.maximum(t["leaf_parent"], 0),
                jnp.maximum(t["leaf_slot"], 0),
            ].add(delta)
        else:
            M = tree.child_node.shape[1]
            K = tree.child_node.shape[2]
            pm = jnp.arange(M)[None, :] == jnp.maximum(t["leaf_parent"], 0)[:, None]
            ps = jnp.arange(K)[None, :] == jnp.maximum(t["leaf_slot"], 0)[:, None]
            hit = pm[:, :, None] & ps[:, None, :] & make_new[:, None, None]
            child_node = jnp.where(hit, new_idx, tree.child_node)
        tree = tree.replace(
            state_packed=state_packed,
            terminal=terminal,
            terminal_value=tval_buf,
            child_node=child_node,
            n_nodes=jnp.full_like(tree.n_nodes, new_idx + 1),
        )
        leaf = jnp.where(at_node_leaf, t["node"], new_idx)
        return tree, leaf

    def _simulate_post_batched(
        self, tree, t, leaf, priors, nn_value, new_idx
    ):
        """Batched phase 2: expand the new leaves with NN priors (unless
        terminal) and back values up the recorded paths.

        Expansion can only apply to the freshly materialized node (slot
        ``new_idx``), so the expansion writes are scalar-index slice updates.
        The leaf's legal mask comes for free from the materializing env step
        (``info.legal_mask``); terminal nodes are never expanded (the Es
        cache short-circuit at src/mcts.py:77-81) and depth-capped nodes
        keep their edges — their NN value still backs up the path.
        """
        M = tree.expanded.shape[1]
        K = self.config.max_children
        leaf_terminal = jnp.take_along_axis(tree.terminal, leaf[:, None], 1)[:, 0]
        leaf_tv = jnp.take_along_axis(tree.terminal_value, leaf[:, None], 1)[:, 0]
        expand = ~t["at_node_leaf"] & ~leaf_terminal  # [B]

        top_p, top_a = self._topk(priors)
        has_mass = top_p > 0
        top_a = jnp.where(has_mass, top_a, -1).astype(jnp.int32)
        top_p = jnp.where(has_mass, top_p, 0.0)

        def wr(buf, val, mask):
            cur = jax.lax.dynamic_index_in_dim(buf, new_idx, 1, keepdims=False)
            m = mask.reshape((-1,) + (1,) * (val.ndim - 1))
            return jax.lax.dynamic_update_index_in_dim(
                buf, jnp.where(m, val, cur), new_idx, 1
            )

        tree = tree.replace(
            expanded=wr(tree.expanded, jnp.ones_like(expand), expand),
            child_action=wr(tree.child_action, top_a, expand),
            child_prior=wr(tree.child_prior, top_p, expand),
        )

        v = jnp.where(leaf_terminal, leaf_tv, nn_value)  # [B]

        # Negamax backup along the recorded paths (src/mcts.py:125-136).
        # Path position j (0 = root edge) receives v * (-1)^(depth - j).
        # Dense one-hot einsum adds by default (MCTSConfig.backup).
        B = v.shape[0]
        depth = t["depth"]  # [B]
        D = t["path_nodes"].shape[1]
        j = jnp.arange(D)[None, :]
        on_path = j < depth[:, None]  # [B, D]
        sign_v = jnp.where((depth[:, None] - j) % 2 == 1, -v[:, None], v[:, None])
        sign_v = sign_v * on_path  # [B, D]
        backup = self.config.backup
        if backup == "auto":
            backup = "dense"
        if backup == "dense":
            Pm = (
                (t["path_nodes"][:, :, None] == jnp.arange(M)[None, None, :])
                & on_path[:, :, None]
            ).astype(jnp.float32)  # [B, D, M]
            S = (
                t["path_slots"][:, :, None] == jnp.arange(K)[None, None, :]
            ).astype(jnp.float32)  # [B, D, K]
            w_add = jnp.einsum(
                "bjm,bjk->bmk", Pm, S * sign_v[:, :, None],
                preferred_element_type=jnp.float32,
            )
            n_add = jnp.einsum(
                "bjm,bjk->bmk", Pm, S * on_path[:, :, None].astype(jnp.float32),
                preferred_element_type=jnp.float32,
            )
            child_W = tree.child_W + w_add
            child_N = tree.child_N + n_add.astype(jnp.int32)
        else:
            # Off-path entries clamp to index (0, 0) with a ZERO update —
            # scatter-add of 0 is a no-op, so no masking pass over the big
            # buffers is needed. Duplicate indices accumulate correctly.
            b_ids = jnp.broadcast_to(jnp.arange(B)[:, None], (B, D))
            pn = jnp.maximum(t["path_nodes"], 0)
            ps = jnp.maximum(t["path_slots"], 0)
            child_W = tree.child_W.at[b_ids, pn, ps].add(sign_v)
            child_N = tree.child_N.at[b_ids, pn, ps].add(on_path.astype(jnp.int32))
        return tree.replace(child_W=child_W, child_N=child_N)

    # -------------------- public API --------------------

    def _root_setup(self, params, root_state, root_legal, rng, add_noise: bool):
        """Root evaluation/expansion (+ exploration noise) -> (tree, aux).

        ``aux`` carries the per-search arrays the wave scan and finalizer
        need (root NN value; gumbel/logit/validity arrays for the gumbel
        driver — zeros under puct so the pytree structure is stable for the
        chunked driver's compiled-program reuse).
        """
        B = root_legal.shape[0]
        cfg = self.config
        use_gumbel = cfg.root_selection == "gumbel"

        # Root evaluation + expansion (the first leaf visit of the root).
        obs = jax.vmap(self.env.observe)(root_state)
        logits, root_nn_value = self.evaluate(params, obs)
        priors, root_fb = _masked_priors_fb(logits, root_legal)
        if (not use_gumbel) and add_noise and cfg.dirichlet_eps > 0:
            rng, sub = jax.random.split(rng)
            n_legal = jnp.maximum(
                jnp.sum(root_legal, axis=-1, keepdims=True), 1
            ).astype(jnp.float32)
            if cfg.dirichlet_alpha_scale is not None:
                alpha_b = cfg.dirichlet_alpha_scale / n_legal  # [B, 1]
            else:
                alpha_b = jnp.full_like(n_legal, cfg.dirichlet_alpha)
            # Masked-out entries get a tiny alpha; the aggregation property of
            # the Dirichlet makes the renormalized legal marginal exact.
            alpha = jnp.where(root_legal, alpha_b, 1e-3)  # [B, A]
            noise = jax.random.dirichlet(sub, alpha) * root_legal
            noise = noise / jnp.maximum(noise.sum(-1, keepdims=True), 1e-30)
            priors = (1 - cfg.dirichlet_eps) * priors + cfg.dirichlet_eps * noise
            priors = priors * root_legal

        tree = jax.vmap(self._empty_tree)(root_state)
        tree = jax.vmap(self._expand_node)(tree, jnp.zeros((B,), jnp.int32), priors)

        K = cfg.max_children
        if use_gumbel:
            slot_valid = tree.child_action[:, 0, :] >= 0  # [B, K]
            slot_logits = jnp.where(
                slot_valid,
                jnp.log(jnp.maximum(tree.child_prior[:, 0, :], 1e-30)),
                NEG_INF,
            )
            rng, g_rng = jax.random.split(rng)
            gumbel = (
                jax.random.gumbel(g_rng, slot_logits.shape)
                if add_noise
                else jnp.zeros_like(slot_logits)
            )
        else:
            slot_valid = jnp.zeros((B, K), bool)
            slot_logits = jnp.zeros((B, K), jnp.float32)
            gumbel = jnp.zeros((B, K), jnp.float32)
        aux = dict(
            root_nn_value=root_nn_value,
            slot_valid=slot_valid,
            slot_logits=slot_logits,
            gumbel=gumbel,
            # Consumed-prior fallback bookkeeping (SURVEY §5 metric): the root
            # expansion is the first consumed prior computation of the search.
            fb_count=root_fb.astype(jnp.int32),
            ex_count=jnp.ones((B,), jnp.int32),
        )
        return tree, aux

    def _root_completed_q(self, tree, aux):
        """Per root slot: completed Q (root-mover persp.; unvisited slots
        take the root NN value) and visit count."""
        N = tree.child_N[:, 0, :]  # [B, K]
        W = tree.child_W[:, 0, :]
        q = jnp.where(N > 0, W / jnp.maximum(N, 1), aux["root_nn_value"][:, None])
        return q, N

    def _gumbel_sigma(self, q, N):
        cfg = self.config
        max_n = jnp.max(N, axis=-1, keepdims=True).astype(jnp.float32)
        return (cfg.gumbel_cvisit + max_n) * cfg.gumbel_cscale * q

    def _wave_scan(self, params, tree, aux, wave_offset, m_sched):
        """Run ``len(m_sched)`` simulation waves starting at global wave index
        ``wave_offset`` (a traced scalar — the chunked driver reuses ONE
        compiled program for every chunk). Gumbel sequential halving
        (Danihelka et al. 2022): each wave forces the root slot that is
        least-visited within the current considered set (size from the
        halving schedule ``m_sched``), ranked by g + logits + sigma(Q)."""
        cfg = self.config
        use_gumbel = cfg.root_selection == "gumbel"
        B = tree.expanded.shape[0]
        if cfg.leaves_per_wave > 1:
            return self._wave_scan_multi(
                params, tree, aux, wave_offset, m_sched
            )

        def sim_step(tree, xs):
            wave, m_considered = xs
            if use_gumbel:
                q, N = self._root_completed_q(tree, aux)
                score = jnp.where(
                    aux["slot_valid"],
                    aux["gumbel"] + aux["slot_logits"] + self._gumbel_sigma(q, N),
                    NEG_INF,
                )
                desc = -jnp.sort(-score, axis=-1)
                kth = jax.lax.dynamic_index_in_dim(
                    desc, m_considered - 1, axis=1, keepdims=False
                )
                considered = score >= kth[:, None]
                # Least-visited of the considered set, score as tie-break
                # (score spans « 1e5, so the keys cannot collide).
                pick = jnp.where(
                    considered, -N.astype(jnp.float32) * 1e5 + score, NEG_INF
                )
                forced = jnp.argmax(pick, axis=-1).astype(jnp.int32)
            else:
                forced = jnp.full((B,), -1, jnp.int32)
            t = jax.vmap(self._traverse)(tree, forced)
            # ONE packed-row fetch per game per wave (round 4; previously
            # two full dots): for expanding games the row of the leaf
            # edge's parent (the env-step input); for terminal/depth-capped
            # games the stopped-at node itself — their env-step output is
            # discarded everywhere (materialize/expand/prior writes are all
            # masked by make_new), but their observe() fields must come
            # from the stored node, and they sit in this same row.
            read_node = jnp.where(t["at_node_leaf"], t["node"], t["leaf_parent"])
            row = jax.vmap(self._node_row)(tree, read_node)
            n = self.env.n
            parent_state = jax.vmap(lambda r: _unpack_state(r, n))(row)
            actions = jax.vmap(self._gather_action)(tree, t)
            # Batched env step. Its info.legal_mask is the leaf's mask for
            # prior computation.
            child_state, step_info = self.env.step_many(parent_state, actions)
            leaf_legal = step_info.legal_mask
            new_idx = wave + 1
            tree, leaf = self._materialize_batched(tree, t, child_state, new_idx)
            # Observation inputs for the leaf: the fresh child state for
            # newly materialized leaves, else the stored node fields sliced
            # from the already-fetched row.
            make_new = ~t["at_node_leaf"]
            stored = jax.vmap(
                lambda r: self._observe_fields_from_row(r, n)
            )(row)

            def sel(fresh, old):
                m = make_new.reshape((-1,) + (1,) * (fresh.ndim - 1))
                return jnp.where(m, fresh, old)

            leaf_state = child_state.replace(
                board=sel(child_state.board, stored[0]),
                side_to_play=sel(child_state.side_to_play, stored[1]),
                reps=sel(child_state.reps, stored[2]),
            )
            obs = jax.vmap(self.env.observe)(leaf_state)
            logits, value = self.evaluate(params, obs)
            priors, fell_back = _masked_priors_fb(logits, leaf_legal)
            # The priors are only CONSUMED where a fresh non-terminal leaf is
            # expanded; a terminal leaf's (discarded) mask can be all-illegal
            # by construction and must not count as a fallback event.
            consumed = make_new & ~child_state.terminated
            tree = self._simulate_post_batched(tree, t, leaf, priors, value, new_idx)
            fb = dict(
                fb=(fell_back & consumed).astype(jnp.int32),
                ex=consumed.astype(jnp.int32),
            )
            return tree, fb

        n_waves = m_sched.shape[0]
        tree, fbs = jax.lax.scan(
            sim_step,
            tree,
            (wave_offset + jnp.arange(n_waves, dtype=jnp.int32), m_sched),
        )
        return tree, jax.tree_util.tree_map(lambda x: jnp.sum(x, axis=0), fbs)

    def _node_rows_multi(self, tree: Tree, nodes: jax.Array) -> jax.Array:
        """Packed state rows for ``nodes: i32[B, L]`` -> f32[B, L, P].

        ``"dot"``: ONE batched [L, M] x [M, P] one-hot matmul per game —
        streams the packed buffer once per WAVE for all L leaves (the whole
        point of multi-leaf waves). ``"gather"``: L row gathers per game.
        """
        if self._node_gather:
            P = tree.state_packed.shape[-1]
            idx = jnp.broadcast_to(nodes[:, :, None], nodes.shape + (P,))
            return jnp.take_along_axis(tree.state_packed, idx, axis=1)
        M = tree.state_packed.shape[1]
        onehot = (nodes[:, :, None] == jnp.arange(M)[None, None, :]).astype(
            jnp.float32
        )  # [B, L, M]
        return jnp.einsum(
            "blm,bmp->blp", onehot, tree.state_packed,
            preferred_element_type=jnp.float32,
        )

    def _wave_scan_multi(self, params, tree, aux, wave_offset, m_sched):
        """Multi-leaf wave scan (``leaves_per_wave`` = L > 1, PUCT only).

        The wave's [B, M, K]-buffer streams — the dense backup einsum adds
        and the child_node link write — are a fixed cost per wave, not per
        leaf. So each wave runs L sequential virtual-loss traversals (traversal l
        sees +vl pseudo-visits on the paths of traversals < l, steering it
        elsewhere), then ONE fused env step + NN forward over the B*L
        leaves, and ONE combined link/backup pass — the big streams are paid
        once per L simulations. A traversal that still lands on an edge an
        earlier leaf claimed is demoted to a duplicate evaluation: its value
        backs up its path, but no second node is linked (documented
        deviation from serial order; see ``MCTSConfig.leaves_per_wave``).
        ``m_sched``'s LENGTH is the chunk's simulation count (its entries
        are unused — gumbel is rejected at init); ``wave_offset`` stays in
        simulation units so the chunked driver's node indexing is unchanged.
        """
        cfg = self.config
        L = cfg.leaves_per_wave
        D = cfg.max_depth
        K = cfg.max_children
        B = tree.expanded.shape[0]
        M = tree.expanded.shape[1]
        n = self.env.n
        n_sims = m_sched.shape[0]
        assert n_sims % L == 0, (n_sims, L)
        f32 = jnp.float32

        def sim_step(tree, sim0):
            # --- L virtual-loss traversals ---------------------------------
            ts = []
            prev_nodes = jnp.zeros((B, 0, D), jnp.int32)
            prev_slots = jnp.zeros((B, 0, D), jnp.int32)
            for _ in range(L):
                t = jax.vmap(
                    lambda tr, pn, ps: self._traverse(tr, jnp.int32(-1), pn, ps)
                )(tree, prev_nodes, prev_slots)
                ts.append(t)
                prev_nodes = jnp.concatenate(
                    [prev_nodes, t["path_nodes"][:, None, :]], 1
                )
                prev_slots = jnp.concatenate(
                    [prev_slots, t["path_slots"][:, None, :]], 1
                )
            parent = jnp.stack([t["leaf_parent"] for t in ts], 1)  # [B, L]
            slot = jnp.stack([t["leaf_slot"] for t in ts], 1)
            stop_node = jnp.stack([t["node"] for t in ts], 1)
            at_node_leaf = jnp.stack([t["at_node_leaf"] for t in ts], 1)
            depth = jnp.stack([t["depth"] for t in ts], 1)
            path_nodes = jnp.stack([t["path_nodes"] for t in ts], 1)  # [B,L,D]
            path_slots = jnp.stack([t["path_slots"] for t in ts], 1)

            # Demote duplicate claims of the same unmaterialized edge: only
            # the FIRST claimant links/expands its node. (A leaf demoted at
            # j cannot hide a collision: l's collision is then with j's own
            # earlier claimant.)
            make_new = ~at_node_leaf  # [B, L]
            for l in range(1, L):
                dup = jnp.zeros((B,), bool)
                for j in range(l):
                    dup = dup | (
                        make_new[:, j]
                        & (parent[:, j] == parent[:, l])
                        & (slot[:, j] == slot[:, l])
                    )
                make_new = make_new.at[:, l].set(make_new[:, l] & ~dup)

            # --- ONE fused state read / env step / NN forward --------------
            read_node = jnp.where(at_node_leaf, stop_node, parent)  # [B, L]
            rows = self._node_rows_multi(tree, read_node)  # [B, L, P]
            flat_rows = rows.reshape(B * L, -1)
            parent_state = jax.vmap(lambda r: _unpack_state(r, n))(flat_rows)
            # Per-leaf B-index ROW gathers (the same form as the traversal's
            # stat reads) rather than a per-element take_along_axis.
            acts = []
            for l in range(L):
                row = jax.vmap(lambda tr, p: tr.child_action[p])(
                    tree, jnp.maximum(parent[:, l], 0)
                )  # [B, K]
                acts.append(
                    jnp.sum(
                        row * (jnp.arange(K)[None, :] == slot[:, l][:, None]),
                        axis=-1,
                    )
                )
            actions = jnp.maximum(jnp.stack(acts, 1), 0).astype(jnp.int32)
            child_state, step_info = self.env.step_many(
                parent_state, actions.reshape(B * L)
            )
            leaf_legal = step_info.legal_mask  # [B*L, A]

            # --- materialize: per-leaf slice writes + ONE link stream ------
            idx0 = sim0 + 1  # node slot of this wave's first leaf
            packed = jax.vmap(_pack_state)(child_state).reshape(B, L, -1)
            term = child_state.terminated.reshape(B, L)
            tvals = jax.vmap(terminal_value)(child_state).reshape(B, L)
            state_packed = tree.state_packed
            terminal_buf = tree.terminal
            tval_buf = tree.terminal_value
            for l in range(L):
                def wr(buf, val, m):
                    cur = jax.lax.dynamic_index_in_dim(
                        buf, idx0 + l, 1, keepdims=False
                    )
                    mm = m.reshape((-1,) + (1,) * (val.ndim - 1))
                    return jax.lax.dynamic_update_index_in_dim(
                        buf, jnp.where(mm, val, cur), idx0 + l, 1
                    )

                mk = make_new[:, l]
                state_packed = wr(state_packed, packed[:, l], mk)
                terminal_buf = wr(terminal_buf, term[:, l], mk)
                tval_buf = wr(tval_buf, tvals[:, l], mk)
            # child_node links for all L leaves in ONE [B, M, K] pass:
            # unmaterialized entries hold -1 and duplicates were demoted, so
            # adding (idx + 1) at each claimed (parent, slot) sets the link.
            pm = (
                jnp.maximum(parent, 0)[:, :, None]
                == jnp.arange(M)[None, None, :]
            ).astype(f32)  # [B, L, M]
            ps = (
                jnp.maximum(slot, 0)[:, :, None]
                == jnp.arange(K)[None, None, :]
            ).astype(f32)  # [B, L, K]
            idxs = (idx0 + jnp.arange(L)).astype(f32)  # [L]
            w_link = make_new.astype(f32) * (idxs[None, :] + 1.0)  # [B, L]
            link_delta = jnp.einsum(
                "blm,blk->bmk", pm * w_link[:, :, None], ps,
                preferred_element_type=f32,
            )
            child_node = tree.child_node + link_delta.astype(jnp.int32)
            tree = tree.replace(
                state_packed=state_packed,
                terminal=terminal_buf,
                terminal_value=tval_buf,
                child_node=child_node,
                n_nodes=jnp.full_like(tree.n_nodes, idx0 + L),
            )

            # --- leaf values / expansion -----------------------------------
            # Terminal flags come straight from the stepped child (fresh or
            # duplicate leaves) or the stored node (at_node_leaf), not from
            # the just-written buffers — a duplicate's slot was never written.
            # Per-leaf scalar reads via the traversal's own cheap indexing.
            stop_term = jnp.stack(
                [
                    jax.vmap(lambda tr, v: tr.terminal[v])(tree, stop_node[:, l])
                    for l in range(L)
                ],
                1,
            )
            stop_tv = jnp.stack(
                [
                    jax.vmap(lambda tr, v: tr.terminal_value[v])(
                        tree, stop_node[:, l]
                    )
                    for l in range(L)
                ],
                1,
            )
            leaf_terminal = jnp.where(at_node_leaf, stop_term, term)  # [B, L]
            leaf_tv = jnp.where(at_node_leaf, stop_tv, tvals)

            anl_flat = at_node_leaf.reshape(B * L)
            stored = jax.vmap(
                lambda r: self._observe_fields_from_row(r, n)
            )(flat_rows)

            def sel(fresh, old):
                m = anl_flat.reshape((-1,) + (1,) * (fresh.ndim - 1))
                return jnp.where(m, old, fresh)

            leaf_state = child_state.replace(
                board=sel(child_state.board, stored[0]),
                side_to_play=sel(child_state.side_to_play, stored[1]),
                reps=sel(child_state.reps, stored[2]),
            )
            obs = jax.vmap(self.env.observe)(leaf_state)
            logits, value = self.evaluate(params, obs)  # [B*L, ...]
            priors, fell_back = _masked_priors_fb(logits, leaf_legal)
            # ONE [B*L, A] top-k for all L leaves.
            top_p, top_a = self._topk(priors)
            has_mass = top_p > 0
            top_a = jnp.where(has_mass, top_a, -1).astype(jnp.int32)
            top_p = jnp.where(has_mass, top_p, 0.0)
            top_a = top_a.reshape(B, L, K)
            top_p = top_p.reshape(B, L, K)
            expand = make_new & ~term  # [B, L]
            expanded_buf = tree.expanded
            ca_buf = tree.child_action
            cp_buf = tree.child_prior
            for l in range(L):
                def wr(buf, val, m):
                    cur = jax.lax.dynamic_index_in_dim(
                        buf, idx0 + l, 1, keepdims=False
                    )
                    mm = m.reshape((-1,) + (1,) * (val.ndim - 1))
                    return jax.lax.dynamic_update_index_in_dim(
                        buf, jnp.where(mm, val, cur), idx0 + l, 1
                    )

                ex = expand[:, l]
                expanded_buf = wr(expanded_buf, jnp.ones_like(ex), ex)
                ca_buf = wr(ca_buf, top_a[:, l], ex)
                cp_buf = wr(cp_buf, top_p[:, l], ex)
            tree = tree.replace(
                expanded=expanded_buf, child_action=ca_buf, child_prior=cp_buf
            )

            # --- ONE combined negamax backup over all L paths --------------
            v = jnp.where(leaf_terminal, leaf_tv, value.reshape(B, L))  # [B, L]
            j = jnp.arange(D)[None, None, :]
            on_path = j < depth[:, :, None]  # [B, L, D]
            sign_v = jnp.where(
                (depth[:, :, None] - j) % 2 == 1, -v[:, :, None], v[:, :, None]
            ) * on_path
            Pm = (
                (path_nodes[:, :, :, None] == jnp.arange(M)[None, None, None, :])
                & on_path[:, :, :, None]
            ).astype(f32).reshape(B, L * D, M)
            S = (
                path_slots[:, :, :, None] == jnp.arange(K)[None, None, None, :]
            ).astype(f32).reshape(B, L * D, K)
            sv = sign_v.reshape(B, L * D)
            op = on_path.astype(f32).reshape(B, L * D)
            w_add = jnp.einsum(
                "bjm,bjk->bmk", Pm, S * sv[:, :, None],
                preferred_element_type=f32,
            )
            n_add = jnp.einsum(
                "bjm,bjk->bmk", Pm, S * op[:, :, None],
                preferred_element_type=f32,
            )
            tree = tree.replace(
                child_W=tree.child_W + w_add,
                child_N=tree.child_N + n_add.astype(jnp.int32),
            )
            consumed = expand  # priors consumed only at fresh expansions
            fb = dict(
                fb=jnp.sum(
                    fell_back.reshape(B, L).astype(jnp.int32)
                    * consumed.astype(jnp.int32),
                    axis=1,
                ),
                ex=jnp.sum(consumed.astype(jnp.int32), axis=1),
            )
            return tree, fb

        waves = n_sims // L
        tree, fbs = jax.lax.scan(
            sim_step,
            tree,
            wave_offset + jnp.arange(waves, dtype=jnp.int32) * L,
        )
        return tree, jax.tree_util.tree_map(lambda x: jnp.sum(x, axis=0), fbs)

    def _finalize(self, tree, aux, root_legal) -> SearchResult:
        """Extract the policy/value outputs from a searched tree."""
        cfg = self.config
        use_gumbel = cfg.root_selection == "gumbel"
        B = root_legal.shape[0]

        # Visit-count policy at the root (src/mcts.py:40-41).
        A = root_legal.shape[-1]
        root_counts = tree.child_N[:, 0, :].astype(jnp.float32)  # [B, K]
        root_actions = tree.child_action[:, 0, :]  # [B, K]
        valid = root_actions >= 0
        probs = jnp.zeros((B, A), jnp.float32)
        batch_idx = jnp.arange(B)[:, None]
        probs = probs.at[batch_idx, jnp.maximum(root_actions, 0)].add(
            jnp.where(valid, root_counts, 0.0)
        )
        total = jnp.maximum(probs.sum(-1, keepdims=True), 1e-30)
        probs = probs / total

        root_visits = jnp.sum(tree.child_N[:, 0, :], axis=-1)
        root_W = jnp.sum(jnp.where(valid, tree.child_W[:, 0, :], 0.0), axis=-1)
        root_value = root_W / jnp.maximum(root_visits.astype(jnp.float32), 1.0)

        if use_gumbel:
            # Winner = argmax of g + logits + sigma(completed Q) among the
            # visited candidates; improved policy (the training target) =
            # softmax(logits + sigma(completed Q)) over the root slots.
            q, N = self._root_completed_q(tree, aux)
            sigma = self._gumbel_sigma(q, N)
            slot_valid = aux["slot_valid"]
            score = jnp.where(
                slot_valid, aux["gumbel"] + aux["slot_logits"] + sigma, NEG_INF
            )
            visited_any = jnp.any(N > 0, axis=-1, keepdims=True)
            win_score = jnp.where(visited_any, jnp.where(N > 0, score, NEG_INF), score)
            win_slot = jnp.argmax(win_score, axis=-1)
            best_action = jnp.maximum(
                jnp.take_along_axis(root_actions, win_slot[:, None], axis=1)[:, 0], 0
            )
            imp = jax.nn.softmax(
                jnp.where(slot_valid, aux["slot_logits"] + sigma, NEG_INF), axis=-1
            ) * slot_valid
            probs = jnp.zeros((B, A), jnp.float32)
            probs = probs.at[batch_idx, jnp.maximum(root_actions, 0)].add(
                jnp.where(valid, imp, 0.0)
            )
            probs = probs / jnp.maximum(probs.sum(-1, keepdims=True), 1e-30)
            # Root value = the halving WINNER's completed Q, not the
            # visit-weighted mean: sequential halving deliberately spends
            # early visits on candidates it then refutes, so the mean is
            # biased low — which would feed spurious resignations and
            # pessimistic bootstrap targets (advisor r2).
            root_value = jnp.take_along_axis(q, win_slot[:, None], axis=1)[:, 0]
        else:
            best_action = jnp.argmax(probs, axis=-1)

        return SearchResult(
            action_probs=probs,
            root_value=root_value,
            root_visits=root_visits,
            best_action=best_action.astype(jnp.int32),
            prior_fallback_rate=aux["fb_count"].astype(jnp.float32)
            / jnp.maximum(aux["ex_count"], 1).astype(jnp.float32),
            tree=tree,
        )

    def _schedule(self) -> list:
        cfg = self.config
        if cfg.root_selection == "gumbel":
            m0 = max(2, min(cfg.gumbel_considered, cfg.max_children))
            return _sh_considered_schedule(cfg.num_simulations, m0)
        return [0] * cfg.num_simulations

    def search(
        self,
        params,
        root_state: EnvState,
        root_legal: jax.Array,
        rng: jax.Array,
        add_noise: bool = True,
    ) -> SearchResult:
        """Run ``num_simulations`` sims for a batch of root states.

        All leading dims are batched: ``root_state`` leaves have shape
        ``[B, ...]``, ``root_legal`` is ``bool[B, A]``.
        """
        tree, aux = self._root_setup(params, root_state, root_legal, rng, add_noise)
        m_sched = jnp.asarray(self._schedule(), jnp.int32)
        tree, fb = self._wave_scan(params, tree, aux, jnp.int32(0), m_sched)
        aux = dict(
            aux,
            fb_count=aux["fb_count"] + fb["fb"],
            ex_count=aux["ex_count"] + fb["ex"],
        )
        return self._finalize(tree, aux, root_legal)

    def search_in_chunks(
        self,
        params,
        root_state: EnvState,
        root_legal: jax.Array,
        rng: jax.Array,
        add_noise: bool = True,
        chunk: int = 100,
    ) -> SearchResult:
        """Result-identical to :meth:`search`, but compiled as ONE reusable
        ``chunk``-wave program called num_simulations/chunk times with the
        tree as a device-resident carry (the wave offset is a traced scalar,
        so every chunk hits the same executable).

        Chunking bounds the compiled program at ``chunk`` waves whatever the
        simulation budget; plain ``search`` (one fused program, zero
        per-chunk dispatch) suits training budgets.
        """
        S = self.config.num_simulations
        L = self.config.leaves_per_wave
        # The chunk must divide the budget AND hold whole waves (L sims per
        # wave); L | S is enforced at init, so counting down from at least
        # L always stops at a valid chunk, L at the latest.
        chunk = max(min(chunk, S), L)
        while S % chunk != 0 or chunk % L != 0:
            chunk -= 1
        if getattr(self, "_chunk_jit", None) is None:
            self._chunk_jit = {
                "setup": jax.jit(self._root_setup, static_argnames="add_noise"),
                "scan": jax.jit(self._wave_scan),
                "final": jax.jit(self._finalize),
            }
        fns = self._chunk_jit
        sched = self._schedule()
        tree, aux = fns["setup"](params, root_state, root_legal, rng, add_noise)
        fb_count, ex_count = aux["fb_count"], aux["ex_count"]
        for lo in range(0, S, chunk):
            m_sched = jnp.asarray(sched[lo : lo + chunk], jnp.int32)
            # aux's own counts stay at their setup values so every chunk hits
            # the SAME compiled program; the running totals accumulate outside
            # (two tiny adds per chunk — noise against a chunk of waves).
            tree, fb = fns["scan"](params, tree, aux, jnp.int32(lo), m_sched)
            fb_count = fb_count + fb["fb"]
            ex_count = ex_count + fb["ex"]
        aux = dict(aux, fb_count=fb_count, ex_count=ex_count)
        return fns["final"](tree, aux, root_legal)


def select_actions(
    probs: jax.Array, legal: jax.Array, temperature: jax.Array, rng: jax.Array
) -> jax.Array:
    """Sample actions from the visit-count policy with temperature.

    ``temp == 0``: argmax with uniform random tie-break (``mcts.py:43-48``);
    otherwise sample from ``counts ** (1/temp)`` renormalized
    (``mcts.py:50-53``).
    """
    B, A = probs.shape
    rng_tie, rng_sample = jax.random.split(rng)
    # Argmax with random tie-break.
    is_max = (probs >= jnp.max(probs, axis=-1, keepdims=True)) & legal
    tie_noise = jax.random.uniform(rng_tie, (B, A))
    greedy = jnp.argmax(is_max * (1.0 + tie_noise), axis=-1)
    # Temperature sampling.
    temperature = jnp.broadcast_to(jnp.asarray(temperature, jnp.float32), (B,))
    t = jnp.maximum(temperature, 1e-6)[:, None]
    logits = jnp.where(probs > 0, jnp.log(jnp.maximum(probs, 1e-30)) / t, NEG_INF)
    sampled = jax.random.categorical(rng_sample, logits, axis=-1)
    return jnp.where(temperature <= 0, greedy, sampled).astype(jnp.int32)
