"""Run-directory tree (reference utils/dirutils.py:9-154).

Builds result/<content>/<data_name>/<method>/<date>_<time>/<title>/{...} with
the same keys, so tooling written against the reference layout keeps working.

A copy of masked_diffusion_tpu/utils/dirs.py; the port imports nothing of
the JAX package. tests/test_torch_port_host.py holds it equal to the
original.
"""

from __future__ import annotations

import datetime
import os


class Dir:
    def __init__(
        self,
        task: str,
        content: str,
        dir_work: str,
        dir_dataset: str = "",
        data_name: str = "",
        data_set: str = "",
        data_size: int = 0,
        date: str = "",
        time: str = "",
        method: str = "",
        title: str = "",
        make_dirs: bool = True,
    ):
        # make_dirs=False builds the path map without touching the
        # filesystem — non-main processes on a pod must not mkdir their own
        # result trees (utils/host.py write policy)
        self.make_dirs = make_dirs
        self.task = task
        self.content = content
        self.dir_work = dir_work
        self.data_name = data_name
        self.data_set = data_set
        self.data_size = data_size
        self.method = method
        self.title = title

        now = datetime.datetime.now()
        self.date = date or now.strftime("%Y_%m_%d")
        self.time = time or now.strftime("%H_%M_%S")

        self.list_dir_sub = {
            "data_name": data_name,
            "data_set": data_set,
            "data_size": "size_{:04d}".format(data_size),
            "time": "{}_{}".format(self.date, self.time),
            "method": method,
            "title": title,
        }
        if task == "train":
            self.list_dir = self._build_dir_train()
        elif task == "sample":
            self.list_dir = self._build_dir_sample()
        else:
            raise ValueError(f"unknown task: {task!r}")

    def _build_dir_train(self):
        save_dir = os.path.join(
            self.dir_work, "result", self.content,
            self.list_dir_sub["data_name"], self.list_dir_sub["method"],
            self.list_dir_sub["time"], self.list_dir_sub["title"],
        )
        j = os.path.join
        dir_list = {
            "img": j(save_dir, "train", "image", "img"),
            "train_img": j(save_dir, "train", "image", "train_image"),
            "mask_img": j(save_dir, "train", "image", "mask_image"),
            "noise_img": j(save_dir, "train", "image", "noise_image"),
            "noisy_img": j(save_dir, "train", "image", "noisy_image"),
            "predict_img": j(save_dir, "train", "image", "predict_image"),
            "sample_img": j(save_dir, "train", "image", "sample_image"),
            "ema_sample_img": j(save_dir, "train", "image", "ema_sample_img"),
            "sample_grid": j(save_dir, "train", "image", "sample_grid"),
            "sample_all_t": j(save_dir, "train", "image", "sample_all_t"),
            "train_loss": j(save_dir, "train", "loss"),
            "time_step": j(save_dir, "train", "time_step"),
            "log": j(save_dir, "log"),
            "model": j(save_dir, "model"),
            "option": j(save_dir, "option"),
            "loss": j(save_dir, "loss"),
            "checkpoint": j(save_dir, "checkpoint"),
            "test_sample_img": j(save_dir, "test", "sample"),
            "test_sample_num": j(save_dir, "test", "num_of_sample"),
            "test_sample_neighbor": j(save_dir, "test", "neighbor_of_sample"),
            "shift_img": j(save_dir, "train", "image", "shift_input"),
            "shift_noisy": j(save_dir, "train", "image", "shift_noisy"),
        }
        skip_unless_shift = {"shift_img", "shift_noisy"}
        if self.make_dirs:
            for key, d in dir_list.items():
                if key in skip_unless_shift and self.method not in ("shift", "mean_shift"):
                    continue
                os.makedirs(d, exist_ok=True)
        return dir_list

    def _build_dir_sample(self):
        sample = os.path.join(
            self.dir_work, "sample",
            self.list_dir_sub["data_name"], self.list_dir_sub["data_set"],
            self.list_dir_sub["data_size"], self.list_dir_sub["time"],
        )
        model = os.path.join(
            self.dir_work, "model",
            self.list_dir_sub["data_name"], self.list_dir_sub["data_set"],
            self.list_dir_sub["data_size"], self.list_dir_sub["time"],
        )
        if self.make_dirs:
            os.makedirs(sample, exist_ok=True)
        return {"sample": sample, "model": model}
