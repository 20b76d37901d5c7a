"""`python -m mcpt_tpu_torch render|inverse|info` (see cli.py).

The guard matters: `render --mesh` starts its ranks with the spawn method,
which imports this module again in each rank under another name."""
if __name__ == "__main__":
    from mcpt_tpu_torch.cli import main

    raise SystemExit(main())
