"""Entry point: ``python -m repro_torch.analyze`` (see repro_torch.analysis.cli)."""
from repro_torch.analysis.cli import main

if __name__ == "__main__":
    raise SystemExit(main())
