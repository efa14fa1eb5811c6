"""COLMAP sparse-model I/O (cameras / images / points3D, text + binary).

A copy of ``efficientdepthestimation_tpu/utils/colmap_io.py`` (numpy,
struct and pickle; scipy imported where a pose is converted), itself an
API-compatible rewrite of the reference's vendored reader
(ReSIDE/colmap_io.py:49-601): same class surface (``CameraPose``, ``Image``,
``Camera`` with pinhole intrinsics helpers and JSON round-trip, ``Point3D``)
and the standard COLMAP file formats
(https://colmap.github.io/format.html).
"""

from __future__ import annotations

import collections
import json
import os
import pickle
import struct

import numpy as np

__all__ = [
    "CameraPose", "Point2D", "Image", "Camera", "Point3D",
    "read_model", "write_model", "qvec2rotmat", "rotmat2qvec",
    "read_cameras_text", "read_cameras_binary", "write_cameras_text",
    "write_cameras_binary", "read_images_text", "read_images_binary",
    "write_images_text", "write_images_binary", "read_points3D_text",
    "read_points3d_binary", "write_points3D_text", "write_points3d_binary",
]

CameraModel = collections.namedtuple("CameraModel", ["model_id", "model_name", "num_params"])

CAMERA_MODELS = [
    CameraModel(0, "SIMPLE_PINHOLE", 3),
    CameraModel(1, "PINHOLE", 4),
    CameraModel(2, "SIMPLE_RADIAL", 4),
    CameraModel(3, "RADIAL", 5),
    CameraModel(4, "OPENCV", 8),
    CameraModel(5, "OPENCV_FISHEYE", 8),
    CameraModel(6, "FULL_OPENCV", 12),
    CameraModel(7, "FOV", 5),
    CameraModel(8, "SIMPLE_RADIAL_FISHEYE", 4),
    CameraModel(9, "RADIAL_FISHEYE", 5),
    CameraModel(10, "THIN_PRISM_FISHEYE", 12),
]
CAMERA_MODEL_IDS = {m.model_id: m for m in CAMERA_MODELS}
CAMERA_MODEL_NAMES = {m.model_name: m for m in CAMERA_MODELS}


def qvec2rotmat(qvec):
    w, x, y, z = qvec
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def rotmat2qvec(R):
    t = np.trace(R)
    if t > 0:
        s = 0.5 / np.sqrt(t + 1.0)
        w = 0.25 / s
        x, y, z = (R[2, 1] - R[1, 2]) * s, (R[0, 2] - R[2, 0]) * s, (R[1, 0] - R[0, 1]) * s
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = 2.0 * np.sqrt(1.0 + R[i, i] - R[j, j] - R[k, k])
        q = np.zeros(4)
        q[i + 1] = 0.25 * s
        q[0] = (R[k, j] - R[j, k]) / s
        q[j + 1] = (R[j, i] + R[i, j]) / s
        q[k + 1] = (R[k, i] + R[i, k]) / s
        w, x, y, z = q
    return np.array([w, x, y, z])


class CameraPose:
    """World→camera pose from a COLMAP (w,x,y,z) quaternion + translation."""

    def __init__(self, qvec, tvec):
        from scipy.spatial.transform import Rotation

        # NOTE: passed straight to scipy (which reads (x,y,z,w)) even though
        # COLMAP stores (w,x,y,z) — faithful to the reference's behaviour
        # (ReSIDE/colmap_io.py:51-52).
        qvec = np.asarray(qvec, float)
        self.R = Rotation.from_quat(qvec)
        self.t = np.asarray(tvec, float).reshape(3, 1)

    def save_pkl(self, f):
        if isinstance(f, str):
            with open(f, "wb") as fp:
                pickle.dump(self, fp)
        else:
            pickle.dump(self, f)

    @staticmethod
    def load_pkl(f):
        if isinstance(f, str):
            with open(f, "rb") as fp:
                return pickle.load(fp)
        return pickle.load(f)


class Point2D:
    def __init__(self, x, y, point3d_id):
        self.x, self.y, self.point3d_id = float(x), float(y), int(point3d_id)


class Image:
    def __init__(self, id, qvec, tvec, camera_id, name, xys, point3D_ids):
        self.id = id
        self.qvec = np.asarray(qvec, float)
        self.tvec = np.asarray(tvec, float)
        self.camera_pose = CameraPose(qvec, tvec)
        self.camera_id = camera_id
        self.name = name
        self.points2D = [Point2D(x, y, pid) for (x, y), pid in zip(xys, point3D_ids)]


class Camera:
    """Pinhole camera: (focal_length, cx, cy) intrinsics + JSON round-trip."""

    def __init__(self, id, model, width, height, params):
        self.id = int(id)
        self.model = str(model)
        self.width = int(width)
        self.height = int(height)
        self.focal_length, self.center_x, self.center_y = map(float, params[:3])

    @property
    def shape(self):
        return self.height, self.width

    def get_matrix(self):
        return np.array([
            [self.focal_length, 0.0, self.center_x],
            [0.0, self.focal_length, self.center_y],
            [0.0, 0.0, 1.0],
        ])

    @staticmethod
    def to_homogeneous_matrix(m):
        assert m.ndim == 2 and m.shape[0] == m.shape[1]
        out = np.zeros((m.shape[0] + 1, m.shape[1] + 1))
        out[:-1, :-1] = m
        out[-1, -1] = 1.0
        return out

    def get_inverse_matrix(self):
        return np.linalg.inv(self.get_matrix())

    def save_json(self, f):
        if isinstance(f, str):
            with open(f, "w") as fp:
                json.dump(self.__dict__, fp)
        else:
            json.dump(self.__dict__, f)

    @staticmethod
    def load_json(f):
        if isinstance(f, str):
            with open(f) as fp:
                args = json.load(fp)
        else:
            args = json.load(f)
        return Camera(args["id"], args["model"], args["width"], args["height"],
                      [args["focal_length"], args["center_x"], args["center_y"]])


class Point3D:
    def __init__(self, id, xyz, rgb, error, image_ids, point2D_idxs):
        self.id = id
        self.xyz = np.asarray(xyz, float)
        self.rgb = np.asarray(rgb)
        self.error = error
        self.image_ids = np.asarray(image_ids)
        self.point2D_idxs = np.asarray(point2D_idxs)

    x = property(lambda self: self.xyz[0])
    y = property(lambda self: self.xyz[1])
    z = property(lambda self: self.xyz[2])
    r = property(lambda self: self.rgb[0])
    g = property(lambda self: self.rgb[1])
    b = property(lambda self: self.rgb[2])


# ---------------------------------------------------------------------------
# text format
# ---------------------------------------------------------------------------


def _data_lines(path):
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith("#"):
                yield line


def read_cameras_text(path):
    cameras = {}
    for line in _data_lines(path):
        elems = line.split()
        cam_id, model = int(elems[0]), elems[1]
        width, height = int(elems[2]), int(elems[3])
        params = np.array(tuple(map(float, elems[4:])))
        cameras[cam_id] = Camera(cam_id, model, width, height, params)
    return cameras


def write_cameras_text(cameras, path):
    with open(path, "w") as f:
        f.write("# Camera list with one line of data per camera:\n"
                "#   CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]\n"
                f"# Number of cameras: {len(cameras)}\n")
        for cam in cameras.values():
            params = (cam.focal_length, cam.center_x, cam.center_y)
            f.write(f"{cam.id} {cam.model} {cam.width} {cam.height} "
                    + " ".join(map(str, params)) + "\n")


def read_images_text(path):
    images = {}
    lines = list(_data_lines(path))
    for meta, pts in zip(lines[0::2], lines[1::2]):
        elems = meta.split()
        image_id = int(elems[0])
        qvec = np.array(tuple(map(float, elems[1:5])))
        tvec = np.array(tuple(map(float, elems[5:8])))
        camera_id = int(elems[8])
        name = elems[9]
        pe = pts.split()
        xys = np.column_stack([tuple(map(float, pe[0::3])),
                               tuple(map(float, pe[1::3]))]) if pe else np.zeros((0, 2))
        ids = np.array(tuple(map(int, pe[2::3]))) if pe else np.zeros((0,), int)
        images[image_id] = Image(image_id, qvec, tvec, camera_id, name, xys, ids)
    return images


def write_images_text(images, path):
    with open(path, "w") as f:
        f.write("# Image list with two lines of data per image:\n"
                "#   IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, CAMERA_ID, NAME\n"
                "#   POINTS2D[] as (X, Y, POINT3D_ID)\n"
                f"# Number of images: {len(images)}\n")
        for img in images.values():
            head = [img.id, *img.qvec, *img.tvec, img.camera_id, img.name]
            f.write(" ".join(map(str, head)) + "\n")
            f.write(" ".join(
                f"{p.x} {p.y} {p.point3d_id}" for p in img.points2D) + "\n")


def read_points3D_text(path):
    points = {}
    for line in _data_lines(path):
        elems = line.split()
        pid = int(elems[0])
        xyz = np.array(tuple(map(float, elems[1:4])))
        rgb = np.array(tuple(map(int, elems[4:7])))
        error = float(elems[7])
        image_ids = np.array(tuple(map(int, elems[8::2])))
        point2D_idxs = np.array(tuple(map(int, elems[9::2])))
        points[pid] = Point3D(pid, xyz, rgb, error, image_ids, point2D_idxs)
    return points


def write_points3D_text(points3D, path):
    with open(path, "w") as f:
        f.write("# 3D point list with one line of data per point:\n"
                "#   POINT3D_ID, X, Y, Z, R, G, B, ERROR, "
                "TRACK[] as (IMAGE_ID, POINT2D_IDX)\n"
                f"# Number of points: {len(points3D)}\n")
        for pt in points3D.values():
            track = " ".join(f"{i} {j}" for i, j in zip(pt.image_ids, pt.point2D_idxs))
            f.write(f"{pt.id} {pt.x} {pt.y} {pt.z} "
                    f"{int(pt.r)} {int(pt.g)} {int(pt.b)} {pt.error} {track}\n")


# ---------------------------------------------------------------------------
# binary format
# ---------------------------------------------------------------------------


def _read(f, fmt):
    size = struct.calcsize("<" + fmt)
    return struct.unpack("<" + fmt, f.read(size))


def _write(f, fmt, *values):
    f.write(struct.pack("<" + fmt, *values))


def read_cameras_binary(path):
    cameras = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "Q")
        for _ in range(n):
            cam_id, model_id, width, height = _read(f, "iiQQ")
            model = CAMERA_MODEL_IDS[model_id]
            params = _read(f, "d" * model.num_params)
            cameras[cam_id] = Camera(cam_id, model.model_name, width, height, params)
    return cameras


def write_cameras_binary(cameras, path):
    with open(path, "wb") as f:
        _write(f, "Q", len(cameras))
        for cam in cameras.values():
            model = CAMERA_MODEL_NAMES[cam.model]
            _write(f, "iiQQ", cam.id, model.model_id, cam.width, cam.height)
            params = [cam.focal_length, cam.center_x, cam.center_y]
            params += [0.0] * (model.num_params - len(params))
            _write(f, "d" * model.num_params, *params[:model.num_params])


def read_images_binary(path):
    images = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "Q")
        for _ in range(n):
            image_id, *qt, camera_id = _read(f, "idddddddi")
            qvec, tvec = np.array(qt[:4]), np.array(qt[4:7])
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (num_pts,) = _read(f, "Q")
            data = _read(f, "ddq" * num_pts)
            xys = np.column_stack([data[0::3], data[1::3]]) if num_pts else np.zeros((0, 2))
            ids = np.array(data[2::3], int) if num_pts else np.zeros((0,), int)
            images[image_id] = Image(image_id, qvec, tvec, camera_id,
                                     name.decode(), xys, ids)
    return images


def write_images_binary(images, path):
    with open(path, "wb") as f:
        _write(f, "Q", len(images))
        for img in images.values():
            _write(f, "idddddddi", img.id, *img.qvec, *img.tvec, img.camera_id)
            f.write(img.name.encode() + b"\x00")
            _write(f, "Q", len(img.points2D))
            for p in img.points2D:
                _write(f, "ddq", p.x, p.y, p.point3d_id)


def read_points3d_binary(path):
    points = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "Q")
        for _ in range(n):
            pid, x, y, z, r, g, b, error = _read(f, "QdddBBBd")
            (track_len,) = _read(f, "Q")
            track = _read(f, "ii" * track_len)
            points[pid] = Point3D(pid, (x, y, z), (r, g, b), error,
                                  track[0::2], track[1::2])
    return points


def write_points3d_binary(points3D, path):
    with open(path, "wb") as f:
        _write(f, "Q", len(points3D))
        for pt in points3D.values():
            _write(f, "QdddBBBd", pt.id, pt.x, pt.y, pt.z,
                   int(pt.r), int(pt.g), int(pt.b), pt.error)
            _write(f, "Q", len(pt.image_ids))
            for i, j in zip(pt.image_ids, pt.point2D_idxs):
                _write(f, "ii", int(i), int(j))


def read_model(path, ext):
    if ext == ".txt":
        cameras = read_cameras_text(os.path.join(path, "cameras" + ext))
        images = read_images_text(os.path.join(path, "images" + ext))
        points3D = read_points3D_text(os.path.join(path, "points3D" + ext))
    else:
        cameras = read_cameras_binary(os.path.join(path, "cameras" + ext))
        images = read_images_binary(os.path.join(path, "images" + ext))
        points3D = read_points3d_binary(os.path.join(path, "points3D" + ext))
    return cameras, images, points3D


def write_model(cameras, images, points3D, path, ext):
    if ext == ".txt":
        write_cameras_text(cameras, os.path.join(path, "cameras" + ext))
        write_images_text(images, os.path.join(path, "images" + ext))
        write_points3D_text(points3D, os.path.join(path, "points3D" + ext))
    else:
        write_cameras_binary(cameras, os.path.join(path, "cameras" + ext))
        write_images_binary(images, os.path.join(path, "images" + ext))
        write_points3d_binary(points3D, os.path.join(path, "points3D" + ext))
