"""The port's bench tools (counterparts of the repo's scripts/ that answer users' questions
through the public API), each run as `python -m mesheditor_tpu_torch.scripts.<name>`:

- render_bench: microseconds per 512-sample block over the ModalRenderBench envelope;
- edit_loop_bench: cold solve, warm re-solve and exact rescale of one material edit;
- cdt_bench: the solve of a Delaunay-meshed irregular surface;
- realimpact_batch: a RealImpact corpus solved object by object, then one object-sharded
  verification render.

Each runs on the card unless `--device cpu` is given, and prints the card it ran on.
"""
