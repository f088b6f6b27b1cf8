"""Filesystem abstraction: LocalFS + HDFSClient.

Counterpart of ``paddle_tpu/fleet/fs.py``, copied as it is: it is
framework-neutral Python (``FS``, ``LocalFS``, ``HDFSClient`` over the
``hadoop fs`` CLI configured with fs.default.name + ugi, and
``fs_for_path``, which routes "hdfs:" and "afs:" paths to
``HDFSClient`` and every other path to ``LocalFS``). The dataset reads a
remote file list through it (``dataset/dataset.py``).
"""
from __future__ import annotations

import os
import shutil
import subprocess
from typing import List, Optional, Tuple


class ExecuteError(Exception):
    pass


class FSFileExistsError(Exception):
    pass


class FSFileNotExistsError(Exception):
    pass


class FSTimeOut(Exception):
    pass


class FS:
    def ls_dir(self, fs_path) -> Tuple[List[str], List[str]]:
        raise NotImplementedError

    def is_file(self, fs_path) -> bool:
        raise NotImplementedError

    def is_dir(self, fs_path) -> bool:
        raise NotImplementedError

    def is_exist(self, fs_path) -> bool:
        raise NotImplementedError

    def upload(self, local_path, fs_path):
        raise NotImplementedError

    def download(self, fs_path, local_path):
        raise NotImplementedError

    def mkdirs(self, fs_path):
        raise NotImplementedError

    def delete(self, fs_path):
        raise NotImplementedError

    def need_upload_download(self) -> bool:
        return False

    def rename(self, fs_src_path, fs_dst_path):
        raise NotImplementedError

    def mv(self, fs_src_path, fs_dst_path, overwrite=False,
           test_exists=False):
        raise NotImplementedError

    def list_dirs(self, fs_path) -> List[str]:
        raise NotImplementedError

    def touch(self, fs_path, exist_ok=True):
        raise NotImplementedError


class LocalFS(FS):
    """fs.py:119 — thin wrapper over os/shutil with the FS contract."""

    def ls_dir(self, fs_path):
        if not self.is_exist(fs_path):
            return [], []
        dirs, files = [], []
        for e in sorted(os.listdir(fs_path)):
            (dirs if os.path.isdir(os.path.join(fs_path, e))
             else files).append(e)
        return dirs, files

    def mkdirs(self, fs_path):
        os.makedirs(fs_path, exist_ok=True)

    def rename(self, src, dst):
        os.rename(src, dst)

    def delete(self, fs_path):
        if self.is_dir(fs_path):
            shutil.rmtree(fs_path, ignore_errors=True)
        elif self.is_file(fs_path):
            os.remove(fs_path)

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

    def mv(self, src, dst, overwrite=False, test_exists=False):
        if test_exists and not self.is_exist(src):
            raise FSFileNotExistsError(src)
        if self.is_exist(dst):
            # match HDFS semantics: `hadoop fs -mv` onto an existing
            # path fails — os.rename would silently clobber on POSIX
            if not overwrite:
                raise FSFileExistsError(dst)
            self.delete(dst)
        os.rename(src, dst)

    def list_dirs(self, fs_path):
        return self.ls_dir(fs_path)[0]

    def upload(self, local_path, fs_path):
        if os.path.isdir(local_path):
            shutil.copytree(local_path, fs_path)
        else:
            shutil.copy(local_path, fs_path)

    download = upload


class HDFSClient(FS):
    """fs.py:258 — drives the `hadoop fs` CLI. configs carries
    fs.default.name + hadoop.job.ugi exactly like the reference;
    `hadoop_bin` overrides the binary (tests inject a fake)."""

    def __init__(self, hadoop_home: Optional[str] = None,
                 configs: Optional[dict] = None,
                 time_out: int = 5 * 60 * 1000, sleep_inter: int = 1000,
                 hadoop_bin: Optional[str] = None):
        self._base = []
        if hadoop_bin:
            self._bin = hadoop_bin
        elif hadoop_home:
            self._bin = os.path.join(hadoop_home, "bin", "hadoop")
        else:
            self._bin = shutil.which("hadoop")
        self._configs = configs or {}
        self._timeout = max(1, time_out // 1000)

    def _run(self, *args) -> str:
        if not self._bin:
            raise ExecuteError(
                "no hadoop binary found — pass hadoop_home/hadoop_bin "
                "or install the hadoop CLI (HDFSClient shells out to "
                "`hadoop fs`, reference fs.py:258)")
        cmd = [self._bin, "fs"]
        for k, v in self._configs.items():
            cmd += ["-D", "%s=%s" % (k, v)]
        cmd += list(args)
        try:
            p = subprocess.run(cmd, capture_output=True,
                               timeout=self._timeout)
        except subprocess.TimeoutExpired as e:
            raise FSTimeOut(str(e)) from None
        if p.returncode != 0:
            raise ExecuteError("%r failed: %s"
                               % (" ".join(args), p.stderr.decode()))
        return p.stdout.decode()

    def need_upload_download(self):
        return True

    def ls_dir(self, fs_path):
        if not self.is_exist(fs_path):
            return [], []
        dirs, files = [], []
        for line in self._run("-ls", fs_path).splitlines():
            parts = line.split()
            if len(parts) < 8:
                continue
            name = parts[-1].rsplit("/", 1)[-1]
            (dirs if parts[0].startswith("d") else files).append(name)
        return dirs, files

    def is_exist(self, fs_path):
        try:
            self._run("-test", "-e", fs_path)
            return True
        except ExecuteError:
            return False

    def is_dir(self, fs_path):
        try:
            self._run("-test", "-d", fs_path)
            return True
        except ExecuteError:
            return False

    def is_file(self, fs_path):
        return self.is_exist(fs_path) and not self.is_dir(fs_path)

    def upload(self, local_path, fs_path):
        self._run("-put", local_path, fs_path)

    def download(self, fs_path, local_path):
        self._run("-get", fs_path, local_path)

    def mkdirs(self, fs_path):
        self._run("-mkdir", "-p", fs_path)

    def delete(self, fs_path):
        if self.is_exist(fs_path):
            self._run("-rmr", fs_path)

    def mv(self, src, dst, overwrite=False, test_exists=False):
        if test_exists and not self.is_exist(src):
            raise FSFileNotExistsError(src)
        if overwrite and self.is_exist(dst):
            self.delete(dst)
        self._run("-mv", src, dst)

    def touch(self, fs_path, exist_ok=True):
        if self.is_exist(fs_path):
            if not exist_ok:
                raise FSFileExistsError(fs_path)
            return
        self._run("-touchz", fs_path)

    def list_dirs(self, fs_path):
        return self.ls_dir(fs_path)[0]


def fs_for_path(path: str, hdfs_configs: Optional[dict] = None) -> FS:
    """Route hdfs:/afs: paths to HDFSClient, others to LocalFS (the
    reference's checkpoint/dataset path dispatch)."""
    if str(path).startswith(("hdfs:", "afs:")):
        return HDFSClient(configs=hdfs_configs)
    return LocalFS()
