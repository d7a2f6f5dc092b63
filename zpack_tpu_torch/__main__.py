"""``python -m zpack_tpu_torch`` → the zpack CLI (``--device cuda|cpu``)."""

from .cli.main import main

raise SystemExit(main())
