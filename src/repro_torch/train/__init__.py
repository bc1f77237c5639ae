from repro_torch.train.trainer import (TrainConfig, init_train_state,
                                       make_train_step)

__all__ = ["TrainConfig", "init_train_state", "make_train_step"]
