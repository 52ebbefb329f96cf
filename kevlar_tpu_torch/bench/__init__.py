"""The port's benchmark entries, counterparts of the JAX package's:

    python -m kevlar_tpu_torch.bench.count_novel   # bench.py
    python -m kevlar_tpu_torch.bench.call          # bench_call.py
    python -m kevlar_tpu_torch.bench.configs       # bench_configs.py
    python -m kevlar_tpu_torch.bench.sim_trio      # tools/sim_trio_bench.py
    python -m kevlar_tpu_torch.bench.verify_e2e    # tools/verify_e2e.py
    python -m kevlar_tpu_torch.bench.helium_workflow_only
                                    # tools/helium_workflow_only.py
    python -m kevlar_tpu_torch.bench.control_plane # tools/control_plane_stress.py
    python -m kevlar_tpu_torch.bench.bigsim        # tools/bigsim_bench.py
    python -m kevlar_tpu_torch.bench.miss_forensics WORKDIR
                                    # tools/miss_forensics.py (host only)

Each draws its JAX entry's data with the same seeded generators in the
same order, times the same regions and prints the same lines on
standard output, JSON with the same keys.  Each but ``miss_forensics``
takes ``--device`` (default ``cuda``; ``cpu`` runs the kernels' plain
PyTorch versions), passes it down to every stage, stops when ``cuda`` is
asked for and there is no card, and prints the card's name and power
limit on a ``#`` line of standard error.  None writes into the repository
(``configs``, ``control_plane``, ``bigsim`` and ``miss_forensics`` write
their JSON where ``--out`` says).
"""

import subprocess
import sys

# the subcommands whose command line takes --device
DEVICE_STAGES = ('count', 'novel', 'filter', 'partition', 'localize', 'call',
                 'alac', 'simlike', 'dist')


def add_device_arg(parser):
    parser.add_argument(
        '--device', default='cuda',
        help='torch device of every stage (default cuda; cpu runs the '
        'kernels\' plain PyTorch versions)')


def start(device):
    """Check that ``device`` can run and print the card's name and power
    limit (``nvidia-smi``) as a ``#`` line on standard error.  Returns the
    ``torch.device``."""
    import torch
    device = torch.device(device)
    if device.type == 'cuda':
        if not torch.cuda.is_available():
            raise SystemExit('no CUDA device (pass --device cpu to run the '
                             'kernels\' plain versions)')
        smi = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'],
            check=True, capture_output=True, text=True).stdout.strip()
        print('# card:', smi, file=sys.stderr, flush=True)
    else:
        print('# device: {} (no card)'.format(device), file=sys.stderr,
              flush=True)
    return device
