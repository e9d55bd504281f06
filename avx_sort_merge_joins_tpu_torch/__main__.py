from .types import default_alloc_conf

default_alloc_conf()  # before the first CUDA call: a user's setting wins
from .cli import main  # noqa: E402

raise SystemExit(main())
