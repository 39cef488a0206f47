"""Experiment entry points of the port, each ``python -m
riptrm_torch.experiment.<name>`` (CUDA device 0 by default; ``--device cpu``
for the CPU):

* ``simulate`` (``simulator``): configs -> solvers -> the CSV contract
  ``<output_path>/<solver>_{x,ineqLagmult,eqLagmult,option,log}.csv``;
* ``generate``: new dataset instances (refuses an existing one without
  ``--overwrite``);
* ``analyze`` (``analyzer``): figures from the logs, under
  ``result/torch/<problem>/``;
* ``benchmark``: the paper-protocol grid through the host runners, summary
  in ``result/benchmark_summary_torch.json``;
* ``protocol_speedrun``: time to the JAX package's per-job targets with the
  batched sweeps, report in ``result/protocol_speedrun_torch.json``;
* ``chip_sweep``: batched multi-start sweep throughput on the card
  (``--fused`` launches the hand-written tCG kernels);
* ``roofline``: the batched tCG kernels against H100 peaks and the bare
  matvec chain (K5).

``cfg`` (configs, overrides, sweeps), ``registry`` (solvers and problem
builders by config name) and ``checkpoint`` (solver-state save/resume)
serve them; ``export_artifact`` saves a batched sweep as a ``torch.export``
program that a serving process loads and runs without re-tracing.
"""
