"""Workload templates: the seven model families the scheduler knows (the
port's copy of the JAX package's ``shockwave_tpu/data/job_table.py``).

Capability parity with reference: scheduler/job_template.py:1-40 and
scheduler/job_table.py:4-124. The (job_type, command, num_steps_arg) strings
are the scheduler<->workload *interface* — traces written against the
reference must parse into the same job types here — so they match verbatim.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional


@dataclasses.dataclass(frozen=True)
class JobTemplate:
    model: str
    command: str
    working_directory: str
    num_steps_arg: str
    needs_data_dir: bool = True
    distributed: bool = False


def _resnet18(bs: int) -> JobTemplate:
    return JobTemplate(
        model=f"ResNet-18 (batch size {bs})",
        command=f"python3 main.py --data_dir=%s/cifar10 --batch_size {bs}",
        working_directory="image_classification/cifar10",
        num_steps_arg="--num_steps",
        distributed=True,
    )


def _resnet50(bs: int) -> JobTemplate:
    return JobTemplate(
        model=f"ResNet-50 (batch size {bs})",
        command=f"python3 main.py -j 4 -a resnet50 -b {bs} %s/imagenet/",
        working_directory="image_classification/imagenet",
        num_steps_arg="--num_minibatches",
        distributed=True,
    )


def _transformer(bs: int) -> JobTemplate:
    return JobTemplate(
        model=f"Transformer (batch size {bs})",
        command=(
            "python3 train.py -data %s/translation/multi30k.atok.low.pt"
            f" -batch_size {bs} -proj_share_weight"
        ),
        working_directory="translation",
        num_steps_arg="-step",
        distributed=True,
    )


def _lm(bs: int) -> JobTemplate:
    return JobTemplate(
        model=f"LM (batch size {bs})",
        command=f"python3 main.py --cuda --data %s/wikitext2 --batch_size {bs}",
        working_directory="language_modeling",
        num_steps_arg="--steps",
        distributed=True,
    )


def _recommendation(bs: int) -> JobTemplate:
    return JobTemplate(
        model=f"Recommendation (batch size {bs})",
        command=f"python3 train.py --data_dir %s/ml-20m/pro_sg/ --batch_size {bs}",
        working_directory="recommendation",
        num_steps_arg="-n",
    )


def _a3c() -> JobTemplate:
    return JobTemplate(
        model="A3C (batch size 4)",
        command="python3 main.py --env PongDeterministic-v4 --workers 4 --amsgrad True",
        working_directory="rl",
        num_steps_arg="--max-steps",
        needs_data_dir=False,
    )


def _cyclegan() -> JobTemplate:
    return JobTemplate(
        model="CycleGAN (batch size 1)",
        command="python3 cyclegan.py --dataset_path %s/monet2photo --decay_epoch 0",
        working_directory="cyclegan",
        num_steps_arg="--n_steps",
    )


def build_job_table(include_gan_rl: bool = False) -> List[JobTemplate]:
    """The generation job table (reference: job_table.py:105-124 enables the
    five profiled families; CycleGAN/A3C templates exist but are not
    generated)."""
    table: List[JobTemplate] = []
    for bs in (32, 64, 128, 256):
        table.append(_resnet18(bs))
    for bs in (16, 32, 64):
        table.append(_resnet50(bs))
    for bs in (16, 32, 64, 128):
        table.append(_transformer(bs))
    for bs in (5, 10, 20, 40, 80):
        table.append(_lm(bs))
    for bs in (512, 1024, 2048, 4096, 8192):
        table.append(_recommendation(bs))
    if include_gan_rl:
        table.append(_a3c())
        table.append(_cyclegan())
    return table


JOB_TABLE: List[JobTemplate] = build_job_table()


def template_for_job_type(job_type: str) -> Optional[JobTemplate]:
    for template in build_job_table(include_gan_rl=True):
        if template.model == job_type:
            return template
    return None
