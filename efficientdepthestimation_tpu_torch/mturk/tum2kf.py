"""TUM RGB-D → KinectFusion flat-directory converter: the counterpart of
MTurk/tum2kf.py and of ``efficientdepthestimation_tpu/mturk/tum2kf.py``.

Associates colour/depth/pose streams by nearest timestamp (the Kinect streams
are unsynchronised), samples frames via ``FrameSampler`` (index- or
time-based ranges/intervals), and emits frame-{i}.color.jpg /
frame-{i}.depth.png (mm uint16) / frame-{i}.pose.txt plus a KinectFusion
``info.txt``. No Open3D/imageio needed — intrinsics are plain constants,
images go through cv2/PIL.
"""

from __future__ import annotations

import argparse
import datetime
import os
import sys
from pathlib import Path

import numpy as np

__all__ = ["FrameSampler", "TUMDataLoader", "main"]


def log(message, end="\n", file=sys.stdout):
    print(f"[{datetime.datetime.now()}] {message}", file=file, end=end)


class FrameSampler:
    """Samples a subset of frames by index or time (tum2kf.py:18-125)."""

    def __init__(self, start=0, stop=-1, step=1, fps=30.0, stop_is_inclusive=False):
        self.start = start
        self.stop = stop
        self.step = step
        self.fps = fps
        self.stop_is_inclusive = stop_is_inclusive

    def __repr__(self):
        kv = ", ".join(f"{k}={v}" for k, v in self.__dict__.items())
        return f"<{type(self).__name__}({kv})>"

    def _clone(self, **updates) -> "FrameSampler":
        options = dict(self.__dict__)
        options.update(updates)
        return FrameSampler(**options)

    def frame_range(self, start, stop=-1):
        return self._clone(start=start, stop=stop)

    def frame_interval(self, step):
        return self._clone(step=step)

    def time_range(self, start, stop=None):
        return self._clone(start=int(start * self.fps),
                           stop=int(stop * self.fps) if stop else -1)

    def time_interval(self, step):
        return self._clone(step=int(step * self.fps))

    def choose(self, frames):
        stop = len(frames) if self.stop < 0 else self.stop
        if self.stop_is_inclusive:
            stop += self.step
        return frames[self.start:stop:self.step]


class TUMDataLoader:
    """Loads a TUM RGB-D sequence with timestamp association."""

    # Fixed TUM/Kinect intrinsics (tum2kf.py:133-141)
    fx, fy, cx, cy = 525.0, 525.0, 319.5, 239.5
    width, height = 640, 480
    fps = 30.0

    def __init__(self, base_dir, is_16_bit=True, pose_path="groundtruth.txt",
                 rgb_files_path="rgb.txt", depth_map_files_path="depth.txt"):
        self.base_dir = Path(base_dir)
        self.pose_path = self.base_dir / pose_path
        self.rgb_files_path = self.base_dir / rgb_files_path
        self.depth_map_files_path = self.base_dir / depth_map_files_path
        self.is_16_bit = is_16_bit
        # 16-bit PNGs store depth ×5000; ROS-bag floats are metric already
        self.depth_scale_factor = 1.0 / 5000.0 if is_16_bit else 1.0
        self.frames = None
        self.depth_maps = None
        self.poses = None
        self._validate()

    def _validate(self):
        if not self.base_dir.is_dir():
            raise RuntimeError(f"Not a readable folder: {self.base_dir}")
        for path in (self.pose_path, self.rgb_files_path, self.depth_map_files_path):
            if not path.is_file():
                raise RuntimeError(f"Missing file: {path}")

    @property
    def num_frames(self):
        return len(self.frames) if self.frames is not None else 0

    @property
    def camera_matrix(self):
        return np.array([[self.fx, 0.0, self.cx],
                         [0.0, self.fy, self.cy],
                         [0.0, 0.0, 1.0]])

    @staticmethod
    def _load_timestamps_and_paths(list_path):
        timestamps, data = [], []
        with open(list_path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                parts = line.split(" ")
                timestamps.append(float(parts[0]))
                data.append(parts[1:])
        return np.array(timestamps), np.array(data)

    def _synced_frame_data(self):
        from scipy.spatial.transform import Rotation

        img_ts, img_paths = self._load_timestamps_and_paths(self.rgb_files_path)
        dep_ts, dep_paths = self._load_timestamps_and_paths(self.depth_map_files_path)
        traj_ts, traj = self._load_timestamps_and_paths(self.pose_path)

        def match(query_ts, target_ts):
            deltas = np.abs(query_ts.reshape(-1, 1) - target_ts.reshape(1, -1))
            return deltas.argmin(axis=0)

        images = img_paths[match(img_ts, dep_ts)].ravel()
        depths = dep_paths.ravel()
        traj_rows = traj[match(traj_ts, dep_ts)]

        poses = []
        for datum in traj_rows:
            tx, ty, tz, qx, qy, qz, qw = map(float, datum)
            rotvec = Rotation.from_quat((qx, qy, qz, qw)).as_rotvec().reshape(-1, 1)
            t = np.array([tx, ty, tz]).reshape(-1, 1)
            poses.append(np.vstack((rotvec, t)))
        return list(zip(map(Path, images), map(Path, depths), poses))

    def load(self, frame_sampler: FrameSampler | None = None):
        import cv2

        frame_sampler = frame_sampler or FrameSampler()
        log("Getting synced frame data...")
        synced = self._synced_frame_data()
        selected = frame_sampler.choose(synced)
        log(f"Selected {len(selected)} frames.")

        frames, depth_maps, poses = [], [], []
        for i, (image_path, depth_path, pose) in enumerate(selected):
            frame = cv2.cvtColor(cv2.imread(str(self.base_dir / image_path)),
                                 cv2.COLOR_BGR2RGB)
            raw = cv2.imread(str(self.base_dir / depth_path), cv2.IMREAD_ANYDEPTH)
            frames.append(frame)
            depth_maps.append((self.depth_scale_factor * raw).astype(np.float32))
            poses.append(pose)
            log(f"[{i + 1}/{len(selected)}] Loading Dataset...\r", end="")
        print()

        self.frames = np.array(frames)
        self.depth_maps = np.array(depth_maps)
        self.poses = np.vstack(poses).squeeze()
        return self


def main(args=None):
    import cv2
    from PIL import Image

    parser = argparse.ArgumentParser()
    parser.add_argument("--base-folder", "--base_folder", required=True)
    parser.add_argument("--output-path", "--output_path", required=True)
    args = parser.parse_args(args)

    loader = TUMDataLoader(args.base_folder).load()
    output_path = os.path.abspath(args.output_path)
    os.makedirs(output_path, exist_ok=True)

    cam_intr = loader.camera_matrix
    trajectory = loader.poses.reshape((-1, 6))

    for i, (color, depth, pose) in enumerate(
            zip(loader.frames, loader.depth_maps, trajectory)):
        name = f"frame-{i:06d}"
        depth_16bit = (1000 * depth).astype(np.uint16)
        pose_mat = np.eye(4, dtype=np.float32)
        pose_mat[:3, :3] = cv2.Rodrigues(pose[:3])[0]
        pose_mat[:3, -1] = pose[-3:].reshape(1, -1)

        Image.fromarray(color).save(os.path.join(output_path, f"{name}.color.jpg"))
        Image.fromarray(depth_16bit).save(
            os.path.join(output_path, f"{name}.depth.png"))
        np.savetxt(os.path.join(output_path, f"{name}.pose.txt"), pose_mat)
        print(f"Saved data for frame {i:06d}...")

    intr = " ".join(map(str, cam_intr.astype(int).ravel()))
    info_txt = (
        "m_versionNumber = 4\n"
        "m_sensorName = UNREAL\n"
        "m_colorWidth = 640\nm_colorHeight = 480\n"
        "m_depthWidth = 640\nm_depthHeight = 480\n"
        "m_depthShift = 1000\n"
        f"m_calibrationColorIntrinsic = {intr} \n"
        "m_calibrationColorExtrinsic = 1 0 0 0 0 1 0 0 0 0 1 0 0 0 0 1 \n"
        f"m_calibrationDepthIntrinsic = {intr} \n"
        "m_calibrationDepthExtrinsic = 1 0 0 0 0 1 0 0 0 0 1 0 0 0 0 1 \n"
        f"m_frames.size = {loader.num_frames}\n"
    )
    with open(os.path.join(output_path, "info.txt"), "w") as f:
        f.write(info_txt)


if __name__ == "__main__":
    main()
