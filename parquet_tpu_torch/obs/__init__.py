"""Observability for the serve daemon: the SLO burn-rate engine
(obs/slo.py). The reference's other obs modules (flight recorder, cost
ledger, structured log, profiler, fleet scrape, trace propagation) are not
ported; serve/server.py lists what each became."""

from .slo import VERDICT_LEVELS, BurnRateEngine, SLOObjective

__all__ = ["BurnRateEngine", "SLOObjective", "VERDICT_LEVELS"]
