"""AlphaZeroForHnefatafl: a JAX AlphaZero stack for tafl games.

A from-scratch JAX/XLA/pjit framework with the capabilities of the reference
``payelmuk91/AlphaZeroForHnefatafl`` project (a Rust tafl rules engine plus an
AlphaZero MCTS layer), re-designed as batched array programs for one
accelerator or a mesh of them:

- ``core``     — rules config, FEN codec, a pure-Python oracle engine (the
                 behavioral spec, successor of the Rust ``game/`` crate), and a
                 vectorized pure-JAX batched environment.
- ``search``   — on-device batched MCTS (array tree, PUCT; successor of
                 ``src/mcts.py`` / ``src/mcts.rs``).
- ``models``   — policy/value networks (plain JAX), the NN backend the reference
                 intended via ``tch`` but never built.
- ``train``    — replay buffer, self-play actors, learner, AlphaZero loop,
                 checkpointing.
- ``parallel`` — device mesh, shardings and collectives for multi-chip /
                 multi-host scaling.
- ``compat``   — API-parity helpers mirroring the reference's sketches
                 (board_to_matrix, bounded replay file).
"""

__version__ = "0.1.0"
