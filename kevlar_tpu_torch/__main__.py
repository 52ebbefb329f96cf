"""``python -m kevlar_tpu_torch`` console entry point."""

from kevlar_tpu_torch.cli import main

if __name__ == '__main__':
    main()
