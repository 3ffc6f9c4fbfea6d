"""File systems (counterpart of paddle_tpu/distributed/fleet/utils/
fs.py): ``LocalFS`` over ``os`` and ``shutil``; ``HDFSClient`` drives a
hadoop deployment's command line in the reference and raises here, as
it does in the JAX package."""
from __future__ import annotations

import os
import shutil

__all__ = ["LocalFS", "HDFSClient", "FSFileExistsError",
           "FSFileNotExistsError"]


class FSFileExistsError(Exception):
    pass


class FSFileNotExistsError(Exception):
    pass


class LocalFS:
    def ls_dir(self, fs_path):
        """(directories, files) directly under ``fs_path``, sorted."""
        if not self.is_exist(fs_path):
            return [], []
        dirs, files = [], []
        for name in sorted(os.listdir(fs_path)):
            (dirs if os.path.isdir(os.path.join(fs_path, name))
             else files).append(name)
        return dirs, files

    def mkdirs(self, fs_path):
        os.makedirs(fs_path, exist_ok=True)

    def is_file(self, fs_path):
        return os.path.isfile(fs_path)

    def is_dir(self, fs_path):
        return os.path.isdir(fs_path)

    def is_exist(self, fs_path):
        return os.path.exists(fs_path)

    def touch(self, fs_path, exist_ok=True):
        if self.is_exist(fs_path):
            if not exist_ok:
                raise FSFileExistsError(fs_path)
            return
        with open(fs_path, "a"):
            pass

    def mv(self, src_path, dst_path, overwrite=False, test_exists=False):
        if not self.is_exist(src_path):
            raise FSFileNotExistsError(src_path)
        if self.is_exist(dst_path):
            if not overwrite:
                raise FSFileExistsError(dst_path)
            self.delete(dst_path)
        shutil.move(src_path, dst_path)

    def delete(self, fs_path):
        if not self.is_exist(fs_path):
            return
        if os.path.isdir(fs_path):
            shutil.rmtree(fs_path)
        else:
            os.remove(fs_path)

    def need_upload_download(self):
        return False

    def rename(self, fs_src_path, fs_dst_path):
        os.rename(fs_src_path, fs_dst_path)

    def list_dirs(self, fs_path):
        return self.ls_dir(fs_path)[0]

    def upload(self, local_path, fs_path):
        shutil.copy(local_path, fs_path)

    def download(self, fs_path, local_path):
        shutil.copy(fs_path, local_path)


class HDFSClient:
    def __init__(self, hadoop_home=None, configs=None, *a, **kw):
        raise NotImplementedError(
            "HDFSClient needs a hadoop deployment (the reference shells "
            "out to $HADOOP_HOME/bin/hadoop); use LocalFS")
