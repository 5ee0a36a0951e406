"""The what-if fleet: batched counterfactual EG solves, the port of the
JAX package's ``shockwave_tpu/whatif/``.

* :class:`Scenario` / :class:`ScenarioBatch` / :func:`solve_scenarios` —
  a batch of scenarios as one launch of kernel A, a block a scenario
  (``python -m shockwave_tpu_torch.tools.whatif sweep`` is the CLI).
* :func:`solve_scenario` / :func:`audit_lanes` — the one-lane launch
  each batched lane equals in every bit, and the audit that checks it.
* :func:`base_problem_from_state` / :func:`base_problem_from_log` —
  seeding from a planner's ``state_dict()`` or a decision log.
* :class:`AdmissionPricer` / :class:`PricingCollector` — the marginal
  price of an admission burst, as lanes of one launch
  (``python -m shockwave_tpu_torch.tools.whatif price``), and online
  through the streaming admission queue
  (``Scheduler.simulate(submitter=..., admission_pricer=...)``).
"""

from shockwave_tpu_torch.whatif.pricing import (  # noqa: F401
    AdmissionPricer,
    PricingCollector,
    PricingDecision,
    burst_problem,
)

from shockwave_tpu_torch.whatif.scenario import (  # noqa: F401
    Scenario,
    ScenarioBatch,
    audit_lanes,
    scenario_metrics,
    scenario_report,
    solve_scenario,
    solve_scenarios,
)
from shockwave_tpu_torch.whatif.seed import (  # noqa: F401
    base_problem_from_log,
    base_problem_from_state,
)
