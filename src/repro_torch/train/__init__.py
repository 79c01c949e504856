from repro_torch.train.loop import (JsonlHistorySink, RestartSignal,
                                    TrainLoopConfig, combine_weighted,
                                    init_train_state, make_train_step,
                                    run_training)

__all__ = ["make_train_step", "run_training", "TrainLoopConfig",
           "combine_weighted", "init_train_state", "RestartSignal",
           "JsonlHistorySink"]
