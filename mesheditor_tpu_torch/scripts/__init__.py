"""The port's tools (counterparts of the repo's scripts/ that answer users' questions
through the public API), each run as `python -m mesheditor_tpu_torch.scripts.<name>`:

- render_bench: microseconds per 512-sample block over the ModalRenderBench envelope;
- edit_loop_bench: cold solve, warm re-solve and exact rescale of one material edit;
- cdt_bench: the solve of a Delaunay-meshed irregular surface;
- realimpact_batch: a RealImpact corpus solved object by object, then one object-sharded
  verification render;
- realimpact_harness: each RealImpact scan solved, retuned to its recordings, struck and
  scored on its partials (BASELINE config 3);
- make_realimpact_double: a synthetic RealImpact object whose recordings come from scipy;
- check_eigensolver: the device eigensolver against scipy on a small bar;
- diag_cdt_solve: the CDT torus solved with the eigensolver's per-iteration trace on;
- tet_corpus_snapshot: the tet mesher's structural snapshot (host only).

Each with device work runs on the card unless `--device cpu` is given, and prints the
card it ran on.
"""
