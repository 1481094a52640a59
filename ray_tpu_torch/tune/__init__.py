"""ray_tpu_torch.tune — hyperparameter tuning over trial actors (the port of
``ray_tpu/tune``).

API parity with the reference's ray.tune essentials: Tuner/TuneConfig,
search-space primitives, ASHA + PBT schedulers, tune.report/get_checkpoint
(shared with ray_tpu_torch.train's session, as in the reference's unified session).
"""

from ray_tpu_torch.train._session import get_checkpoint, report  # noqa: F401
from ray_tpu_torch.tune.result_grid import ResultGrid, TrialResult  # noqa: F401
from ray_tpu_torch.tune.search import (  # noqa: F401
    BasicVariantGenerator,
    ConcurrencyLimiter,
    Searcher,
    TPESearcher,
)
from ray_tpu_torch.tune.schedulers import (  # noqa: F401
    ASHAScheduler,
    AsyncHyperBandScheduler,
    FIFOScheduler,
    HyperBandScheduler,
    MedianStoppingRule,
    PopulationBasedTraining,
)
from ray_tpu_torch.tune.search_space import (  # noqa: F401
    choice,
    grid_search,
    loguniform,
    randint,
    uniform,
)
from ray_tpu_torch.tune.tuner import (  # noqa: F401
    TuneConfig,
    Tuner,
    with_parameters,
    with_resources,
)
