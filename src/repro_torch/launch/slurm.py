"""Slurm job-script generation (the JUBE platform.xml analog), for GPU
nodes.

Port of ``src/repro/launch/slurm.py``. CARAML populates job templates
from a system config and submits them to Slurm. The reference renders
scripts for TPU pod slices (one task per host, JAX's coordinator
variables); the port renders them for nodes of NVIDIA cards: one task
per GPU (``--ntasks-per-node`` equal to ``--gpus-per-node``), an open
CPU mask for the collectives' helper threads (the paper's Section V
lesson), and ``torch.distributed``'s rendezvous variables: ``MASTER_ADDR``
(the allocation's first host), ``MASTER_PORT``, ``WORLD_SIZE`` and, in
each task, ``RANK`` and ``LOCAL_RANK`` from ``SLURM_PROCID`` and
``SLURM_LOCALID``. No ``REPRO_TPU`` or ``JAX_*`` variable is set.

Each task joins the world from those variables (``launch.mesh.
init_world``): the bench CLI runs the points whose placement fills the
world and rank 0 writes the records; ``launch.train --placement dpN``
trains as one of the N ranks. :func:`write_launch_scripts` renders the
training scripts
and the dry run's (``repro_torch.launch.dryrun --all``), which counts
every cell on ``meta`` tensors in one task.
"""
from __future__ import annotations

import pathlib
from dataclasses import dataclass, field


@dataclass
class SystemConfig:
    """Per-system template values (the platform.xml analog): a node of
    four H100s."""
    name: str = "h100-node"
    gpus_per_node: int = 4
    cpus_per_gpu: int = 16
    partition: str = "gpu"
    account: str = "repro"
    container: str = ""              # optional container image
    master_port: int = 29500
    env: dict = field(default_factory=dict)


TEMPLATE = """#!/bin/bash
#SBATCH --job-name={job_name}
#SBATCH --partition={partition}
#SBATCH --account={account}
#SBATCH --nodes={n_nodes}
#SBATCH --ntasks-per-node={tasks_per_node}
#SBATCH --gpus-per-node={tasks_per_node}
#SBATCH --cpus-per-task={cpus}
#SBATCH --exclusive
#SBATCH --time={time_limit}
#SBATCH --output={log_dir}/%x_%j.out

# one task per GPU; open CPU mask so collective helper threads can float
# (CARAML Sec. V: over-tight masks starve NCCL helper threads)
export SLURM_CPU_BIND=none
{env_exports}
# torch.distributed rendezvous: the first host of the allocation
export MASTER_ADDR=$(scontrol show hostnames $SLURM_JOB_NODELIST | head -n1)
export MASTER_PORT={master_port}
export WORLD_SIZE=$SLURM_NTASKS

srun {container_prefix}bash -c 'export RANK=$SLURM_PROCID LOCAL_RANK=$SLURM_LOCALID; exec python -m {module} {args}'
"""


def render_job(*, job_name: str, module: str, args: str,
               system: SystemConfig, n_nodes: int = 1,
               tasks_per_node: int | None = None,
               time_limit: str = "02:00:00", log_dir: str = "logs") -> str:
    """Render one sbatch script: ``n_nodes`` nodes of ``tasks_per_node``
    tasks, one GPU each (default: every GPU of the node)."""
    env_exports = "\n".join(f"export {k}={v}" for k, v in system.env.items())
    container_prefix = (f"apptainer exec --nv {system.container} "
                        if system.container else "")
    tasks = system.gpus_per_node if tasks_per_node is None else tasks_per_node
    return TEMPLATE.format(
        job_name=job_name, partition=system.partition, account=system.account,
        n_nodes=n_nodes, tasks_per_node=tasks, cpus=system.cpus_per_gpu,
        time_limit=time_limit, log_dir=log_dir, env_exports=env_exports,
        master_port=system.master_port, container_prefix=container_prefix,
        module=module, args=args)


def render_bench_job(*, workload: str, placement, point: dict,
                     system: SystemConfig | None = None,
                     out: str = "artifacts/bench_torch",
                     power: str = "auto",
                     warmup: int | None = None,
                     iters: int | None = None,
                     job_suffix: str = "") -> str:
    """The deferred-record script: re-run ONE bench point on a Slurm
    allocation sized to its mesh (``placement`` is a
    ``repro_torch.bench.spec.Placement``): one task per device, on as
    few nodes as hold them. The bench runner renders this when a point's
    mesh exceeds the devices of its process instead of erroring.
    ``out``/``power``/``warmup``/``iters`` forward the invoking run's
    settings so the cluster record lands in the same results tree with a
    point key that joins the local sweep (power_source is part of the
    key)."""
    system = system or SystemConfig()
    n = max(1, placement.n_devices)
    n_nodes = -(-n // system.gpus_per_node)
    points = ",".join(f"{k}={point[k]}" for k in sorted(point))
    args = f"run --suite {workload} --out {out} --power {power}"
    if warmup is not None:
        args += f" --warmup {warmup}"
    if iters is not None:
        args += f" --iters {iters}"
    if points:
        args += f" --points {points}"
    return render_job(
        job_name=f"bench_{workload}_{placement.label}{job_suffix}",
        module="repro_torch.bench", args=args, system=system,
        n_nodes=n_nodes, tasks_per_node=-(-n // n_nodes))


def write_launch_scripts(out_dir, archs, system: SystemConfig | None = None):
    """Render train scripts for every arch (one node and two, every task
    a rank of the script's dp world) and the dry-run script (one
    task)."""
    system = system or SystemConfig()
    out = pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    written = []
    for arch in archs:
        for nodes, tag in ((1, "node1"), (2, "node2")):
            script = render_job(
                job_name=f"train_{arch}_{tag}",
                module="repro_torch.launch.train",
                args=(f"--arch {arch} --preset full --placement "
                      f"dp{nodes * system.gpus_per_node}"),
                system=system, n_nodes=nodes)
            p = out / f"train_{arch}_{tag}.sbatch"
            p.write_text(script)
            written.append(str(p))
    dry = render_job(job_name="dryrun", module="repro_torch.launch.dryrun",
                     args="--all", system=system, n_nodes=1,
                     tasks_per_node=1)
    (out / "dryrun.sbatch").write_text(dry)
    written.append(str(out / "dryrun.sbatch"))
    return written
