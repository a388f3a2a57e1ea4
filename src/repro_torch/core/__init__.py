"""The paper's contribution: data parallelism by parameter averaging.
The reference's ``replica_specs`` (a ``shard_map`` spec) has no
counterpart: the mesh engine's rank holds its replica as it is."""
from repro_torch.core.param_avg import (COMPRESSIONS, EXPECTED_COLLECTIVE,
                                        STRATEGIES, ExchangeConfig,
                                        Exchanger, ReplicaGroup,
                                        as_exchanger, exchange_average,
                                        replica_spread, replicate,
                                        unreplicate)
from repro_torch.core.steps import (TrainState, init_exchange_state,
                                    init_grad_avg_state,
                                    init_param_avg_state, make_eval_step,
                                    make_grad_avg_step,
                                    make_mesh_param_avg_step,
                                    make_param_avg_step, make_serve_step,
                                    reshape_for_replicas)
