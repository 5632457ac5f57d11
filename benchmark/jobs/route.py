"""Job kind "route": a placement made by VPR's annealer (the port's
native serial placer) at set-up, routed congestion-driven by the run's
one Router: ``Router(rr, RouterOpts(...)).route(term)``, as
``flow.run_route`` calls it."""


def prepare(run, job) -> None:
    job.pos = run.fe.place_native(job.seed)
    job.term = run.fe.terminals(job.pos)
    if run.router is None:
        from parallel_eda_tpu_torch.route.router import Router

        run.router = Router(run.fe.rr, run.router_opts(), device=run.device)


def run(run, job):
    """The job's RouteResult."""
    return run.router.route(job.term)
