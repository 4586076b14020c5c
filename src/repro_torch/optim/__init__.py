from repro_torch.optim.optimizers import (adamw_init, adamw_update,
                                          clip_grads, init_opt, opt_update,
                                          sgd_init, sgd_update)

__all__ = ["adamw_init", "adamw_update", "clip_grads", "init_opt",
           "opt_update", "sgd_init", "sgd_update"]
