"""Distribution across ranks: the sharding solver (``sharding``) and the
collectives (``collectives``)."""
from .sharding import Layout, batch_spec, cache_shardings, data_specs, param_shardings, spec_for_dims
