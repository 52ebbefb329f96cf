#!/usr/bin/env python
"""kevlar-tpu: TPU-native reference-free trio variant discovery."""

from setuptools import setup, find_packages

setup(
    name='kevlar-tpu',
    version='0.1.0',
    description='TPU-native reference-free de novo variant discovery '
                'in trios (JAX/XLA/Pallas)',
    long_description=open('README.md').read(),
    long_description_content_type='text/markdown',
    packages=find_packages(exclude=('tests',)),
    package_data={'kevlar_tpu.native': ['*.cpp'],
                  'kevlar_tpu_torch': ['csrc/*.cu', 'csrc/*.cpp']},
    python_requires='>=3.10',
    install_requires=['jax', 'numpy'],
    entry_points={
        'console_scripts': [
            'kevlar-tpu = kevlar_tpu.cli:main',
            # the PyTorch + CUDA port: every subcommand but warm
            'kevlar-tpu-torch = kevlar_tpu_torch.cli:main',
            # sandbox utilities (reference setup.py:65 installs
            # kevlar/sandbox/*.py as scripts)
            'kevlar-tpu-compact = kevlar_tpu.sandbox.compact:main',
            'kevlar-tpu-get-partitions = '
            'kevlar_tpu.sandbox.get_partitions:main',
            'kevlar-tpu-subsketch = kevlar_tpu.sandbox.subsketch:main',
            'kevlar-tpu-torch-compact = kevlar_tpu_torch.sandbox.compact:main',
            'kevlar-tpu-torch-get-partitions = '
            'kevlar_tpu_torch.sandbox.get_partitions:main',
            'kevlar-tpu-torch-subsketch = '
            'kevlar_tpu_torch.sandbox.subsketch:main',
        ],
    },
    classifiers=[
        'Intended Audience :: Science/Research',
        'Topic :: Scientific/Engineering :: Bio-Informatics',
        'Programming Language :: Python :: 3',
    ],
)
