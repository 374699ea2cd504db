"""Tuning core of the port: parameter spaces, annotations, platform
profiles, the tuning database and the dispatch runtime."""
from .annotate import DispatchSpec, Tunable, get_tunable, registered, tunable  # noqa: F401
from .params import Config, Constraint, Param, ParamSpace, PowerOfTwoParam  # noqa: F401
from .bgtune import BackgroundTune, BackgroundTuner, background_policy  # noqa: F401,E402
from .runtime import entry_point  # noqa: F401,E402
