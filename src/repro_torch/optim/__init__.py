from repro_torch.optim.adamw import AdamW, init_opt_state  # noqa: F401
from repro_torch.optim.schedule import cosine_schedule  # noqa: F401
