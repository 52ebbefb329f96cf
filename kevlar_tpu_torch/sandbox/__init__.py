"""Sandbox utilities: small shipped scripts outside the main CLI.

The reference installs these as standalone console scripts
(reference setup.py:65, kevlar/sandbox/*.py); here each is a module with a
``main(argv)`` entry point, runnable as
``python -m kevlar_tpu_torch.sandbox.<name>`` and installed as a
``kevlar-tpu-torch-<name>`` console script (copies of
``kevlar_tpu.sandbox``'s with the imports rewritten).
"""
