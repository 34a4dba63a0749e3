from .optimizer import (AdamWState, adamw_init, adamw_update,  # noqa: F401
                        clip_by_global_norm, wsd_schedule)
from .train_step import make_train_step  # noqa: F401
