"""Replay a ROS1 bag through the pipeline Runner (the port's copy of
`lio_slam_tpu/io/bag_replay.py`: the bag is read and decoded on the host,
and each scan runs on the Runner's device).

Equivalent of the reference's validation workflow — `rosbag play *.bag` +
`roslaunch liorf run_lio_sam_*.launch` (src/liorf/README.md:137-158) — but in
process: messages stream from the bag in time order, IMU samples buffer into
the per-scan window the deskew/preintegration stages consume (the role of the
2000-deep subscriber queues, imageProjection.cpp:116-118), and the newest GPS
fix near each scan rides along.

Input-side fidelity mirrored from ImageProjection:
- 2-scan delay buffer (cachePointCloud, imageProjection.cpp:214-219): a scan
  is only processed once the NEXT lidar message arrives, guaranteeing the IMU
  stream covers the full scan sweep (the rotation table must extend past the
  scan tail).  The final scan flushes at stream end.
- IMU orientation pass-through (imuDeskewInfo :381-385): 9-axis quaternions
  ride in the window dict for attitude initialization (extQRPY applied by the
  Runner, utility.h:333-366).
- NavSatFix covariance pass-through (gpsHandler/addGPSFactor :1984-1989):
  the position-covariance diagonal feeds the GPS factor information.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np

from lio_slam_tpu_torch.io import rosbag as rb
from lio_slam_tpu_torch.pipeline.live import LiveFeed


@dataclass
class BagTopics:
    lidar: str = "/velodyne_points"
    imu: str = "/imu/data"
    gps: Optional[str] = None          # corrected stream (NavSatFix/GpswithHeading)
    raw_gps: Optional[str] = None      # raw vehicle stream ("gpsdata" FSM role)
    sensor: str = "velodyne"           # formats adapter key


def replay_bag(runner, bag_path: str, topics: Optional[BagTopics] = None,
               max_scans: Optional[int] = None,
               use_native: Optional[bool] = None) -> Iterator:
    """Stream a bag through `runner.process_scan`; yields each ScanResult
    (None results from the mappingProcessInterval throttle are skipped).

    The stream rides the production `pipeline.live.LiveFeed` (native SPSC
    sample queues + 2-scan delay buffer + stale-pop IMU windowing); the bag
    reader is just one possible producer.  `use_native` as in `LiveFeed`:
    True demands the native queues and raises where they do not build."""
    topics = topics or BagTopics()
    reader = rb.BagReader(bag_path)
    want = [t for t in (topics.lidar, topics.imu, topics.gps,
                        topics.raw_gps) if t]
    feed = LiveFeed(runner, use_native=use_native)
    n_scans = 0

    for msg in reader.read_messages(want):
        if topics.raw_gps and msg.topic == topics.raw_gps:
            if msg.msg_type == "sensor_driver_msgs/GpswithHeading":
                g = rb.decode_gps_with_heading(msg.raw)
                feed.push_raw_gps(g.stamp, g.gps.latitude, g.gps.longitude,
                                  g.gps.altitude, heading=g.heading)
            else:
                g = rb.decode_navsatfix(msg.raw)
                feed.push_raw_gps(g.stamp, g.latitude, g.longitude, g.altitude)
        elif msg.topic == topics.imu:
            m = rb.decode_imu(msg.raw)
            feed.push_imu(m.stamp, m.linear_acceleration,
                          m.angular_velocity, m.orientation)
        elif topics.gps and msg.topic == topics.gps:
            if msg.msg_type == "sensor_driver_msgs/GpswithHeading":
                g = rb.decode_gps_with_heading(msg.raw)
                cov = np.asarray(g.gps.position_covariance,
                                 np.float64).reshape(3, 3).diagonal().copy()
                feed.push_gps(g.stamp, g.gps.latitude, g.gps.longitude,
                              g.gps.altitude, g.gps.status, covariance=cov,
                              heading=g.heading)
            else:
                g = rb.decode_navsatfix(msg.raw)
                cov = np.asarray(g.position_covariance,
                                 np.float64).reshape(3, 3).diagonal().copy()
                feed.push_gps(g.stamp, g.latitude, g.longitude, g.altitude,
                              g.status, covariance=cov)
        elif msg.topic == topics.lidar:
            pc2 = rb.decode_pointcloud2(msg.raw)
            res = feed.push_scan(rb.scan_from_pointcloud2(pc2, topics.sensor))
            if res is not None:
                n_scans += 1
                yield res
                if max_scans is not None and n_scans >= max_scans:
                    return
    # stream end: flush the delayed final scan
    if max_scans is None or n_scans < max_scans:
        res = feed.flush()
        if res is not None:
            yield res
