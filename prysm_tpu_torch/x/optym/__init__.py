"""Optimization toolkit: step-API optimizers, governors, DLS, activations.

Counterpart of ``prysm_tpu/x/optym/__init__.py``, with the same public names.
"""
from .optimizers import (  # NOQA
    GradientDescent, AdaGrad, RMSProp, Adam, RAdam, AdaMomentum, Yogi,
    LBFGSB, PrysmLBFGSB, runN, run_until,
)
from .governors import (  # NOQA
    Governor, AnyGovernor, AllGovernor, MaxIterations, MaxEvaluations,
    FunctionTolerance, GradientTolerance, StepTolerance, ConstraintTolerance,
    StepRecord, GovernorDecision, OptimizationResult,
)
from .problem import Problem, as_problem  # NOQA
from .least_squares import (  # NOQA
    DampedLeastSquares, damped_least_squares, DampedLeastSquaresResult,
)
from .activation import (  # NOQA
    Softmax, GumbelSoftmax, DiscreteEncoder, Tanh, Arctan, Softplus, Sigmoid,
)
from .cost import (  # NOQA
    bias_and_gain_invariant_error, mean_square_error, negative_loglikelihood,
)
from .operators import SpatialGradient2D  # NOQA
from .sample_problems import (  # NOQA
    SphereProblem, RosenbrockProblem, RastriginProblem, HimmelblauProblem,
    sphere, rosenbrock, rastrigin, himmelblau,
)
from .linesearch import ls_strong_wolfe  # NOQA
from .plotting import plot_convergence  # NOQA
from .checkpoint import (  # NOQA
    save_checkpoint, load_checkpoint, optimizer_state,
    restore_optimizer_state, CheckpointGovernor,
)
