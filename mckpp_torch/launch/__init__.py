"""Launch scripts of the port (data, no code).

``KPPocean_gpu.slurm``: a Slurm job over GPU nodes, one ``torchrun`` a
node starting one process a card, running ``python -m mckpp_torch.cli
--distributed`` from the directory that holds the namelist and its
inputs.  Submit it with ``sbatch``.
"""
